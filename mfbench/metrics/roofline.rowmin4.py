"""Kernel 4's share of its roofline in the traced fit: the least time of
one row pass over the (2 fascicles, CSF, EAR) voxels' real grid
(``roofline.row_pass_ms``, published H100 peaks) over the device time of
every ``rowmin4_kernel`` launch of the fit (overflow batches included)."""

from mfbench import roofline


def read(ctx):
    return ctx.kernel_roofline("rowmin4_kernel", roofline.row_pass_ms(
        "rowmin4", ctx.bucket_counts.get("2,1,1", 0), ctx.samples,
        ctx.cfg["num_atom"], ctx.cfg.get("num_ear") or 0))
