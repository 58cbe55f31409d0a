"""Voxels a fit whose atoms the fast path's scan could not certify: those
re-scored in float64 among their near-ties plus those solved by the
exhaustive float64 fallback (the program's counter
``models/fit.CERTIFY``, "rescored" + "fallback"). The counter runs over
the process: its share of every fast-path voxel it counted, times the
fast-path voxels of one fit (the mix's buckets with fascicles), is the
mean over the fits (the warm-up fit's few chunks weigh in by their
voxels). Nothing where the program has no such counter or counted no
voxel."""

import importlib


def read(ctx):
    try:
        fit = importlib.import_module(
            "microstructure_fingerprinting_torch.models.fit")
    except ImportError:
        return None
    counts = getattr(fit, "CERTIFY", None)
    if not counts:
        return None
    total = sum(counts.values())
    if not total:
        return None
    per_fit = sum(n for key, n in ctx.bucket_counts.items()
                  if not key.startswith("0,"))
    return per_fit * (counts["rescored"] + counts["fallback"]) / total
