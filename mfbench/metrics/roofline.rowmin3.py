"""Kernel 2's share of its roofline in the traced fit: the least time of
one row pass over the (2 fascicles, CSF) voxels' real grid
(``roofline.row_pass_ms``, published H100 peaks) over the device time of
every ``rowmin3_kernel`` launch of the fit (overflow batches included)."""

from mfbench import roofline


def read(ctx):
    return ctx.kernel_roofline("rowmin3_kernel", roofline.row_pass_ms(
        "rowmin3", ctx.bucket_counts.get("2,1,0", 0), ctx.samples,
        ctx.cfg["num_atom"]))
