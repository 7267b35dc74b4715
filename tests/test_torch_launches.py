"""``ops.launches``: every kernel module's launch counter read and cleared
in one place."""

from pose_transfer_torch.ops import (launches, nn_loss, norm, warp_fused,
                                     warp_pallas)


def test_launch_counts_hold_every_kernel_module():
    modules = (warp_fused, warp_pallas, nn_loss, norm)
    saved = [dict(m.LAUNCHES) for m in modules]
    try:
        got = launches.launch_counts()
        for m in modules:
            assert {k: got[k] for k in m.LAUNCHES} == m.LAUNCHES
        launches.count_launch(nn_loss.LAUNCHES, "nn_loss_fwd")
        launches.count_launch(norm.LAUNCHES, "volume_norm_bwd")
        launches.count_launch(warp_pallas.LAUNCHES, "warp_fold",
                              "warp_fold_idx")
        after = launches.launch_counts()
        assert after["nn_loss_fwd"] == got["nn_loss_fwd"] + 1
        assert after["warp_fold"] == got["warp_fold"] + 1
        assert after["warp_fold_idx"] == got["warp_fold_idx"] + 1
        assert after["volume_norm_bwd"] == got["volume_norm_bwd"] + 1
        launches.reset_launch_counts()
        assert set(launches.launch_counts().values()) == {0}
        assert all(not any(m.LAUNCHES.values()) for m in modules)
    finally:
        for m, counts in zip(modules, saved):
            m.LAUNCHES.update(counts)
