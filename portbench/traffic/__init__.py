"""The traffic kinds: one generator module each (``<kind>.py``), and
the mixes of parameters they read (``<mix>.json``)."""
