"""Pair-CSV generation from the annotation files, with the training entry point's
flags.

Counterpart of ``pose_transfer_tpu/cli/create_pairs.py``. It writes files
only and touches no device.

Run: ``python -m pose_transfer_torch.cli.create_pairs --dataset fasion
--pose_dim 18 --data_Dir <dir>``
"""

from __future__ import annotations

from ..data.pairs import write_pair_files
from .opts import Opts


def main(argv=None):
    p = Opts()
    p.init()
    p.parser.add_argument("--write_iterative", default=0, type=int,
                          help="also write the seqN iterative pair files "
                               "(pose_dim 16 only)")
    opt = Opts.derive(p.parser.parse_args(argv))
    write_pair_files(opt)


if __name__ == "__main__":
    main()
