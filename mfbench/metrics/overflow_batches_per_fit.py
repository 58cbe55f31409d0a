"""Overflow batches a fit: the row-pass launches (kernels 2 and 4,
``ops/kernels.LAUNCHES``) beyond one a chunk of the buckets that run a
row pass, (2 fascicles, CSF) on kernel 2 and (2 fascicles, CSF, EAR) on
kernel 4. Each is a batch of the voxels whose row band overflowed,
re-solved eagerly at a wider band (``models/fit.run_bucket_fast``). The
mean over the window's fits; nothing where no fit ran a row pass (the
general path, ``engine="xla"``)."""

import math

ROW_PASS = {"rowmin3": "2,1,0", "rowmin4": "2,1,1"}


def read(ctx):
    if not any(f["launches"].get(k, 0) for f in ctx.fits for k in ROW_PASS):
        return None
    per_fit = []
    for f in ctx.fits:
        n = 0
        for kernel, bucket in ROW_PASS.items():
            chunks = math.ceil(ctx.bucket_counts.get(bucket, 0) / ctx.batch)
            n += f["launches"].get(kernel, 0) - chunks
        per_fit.append(n)
    return sum(per_fit) / len(per_fit)
