"""Runnable examples, each ``python -m
microstructure_fingerprinting_torch.examples.<name> [n] [--device cpu]``:

  * ``demo_synthetic``: a small noisy 2-fascicle + CSF volume through
    ``MFModel.fit``, its recovery, its NIfTI maps;
  * ``exactness_check``: planted atoms of a 986-atom dictionary recovered
    exactly by ``run_bucket_fast``, with and without EAR;
  * ``whole_brain``: a whole-brain-sized volume of mixed buckets, its
    bucket mix and voxels/s on one card and on every card in sight;
  * ``profile_stages``: device time of each stage of the flagship and
    EAR chunks (``utils/profiling.StageTimer``);
  * ``ear_rsweep``: the EAR two-pass scan + finalize at several row
    budgets R, time and overflow;
  * ``kernel_phases``: where the time of kernels 6-13 goes, phase by
    phase (a second build with ``-DMF_PHASES``) and launch by launch;
  * ``df2_probe``: kernel 6 timed with parts of its source cut out, and
    a micro-benchmark of the tensor cores' float64 and int8 ``mma``;
  * ``hoist_probe``: kernels 9 and 10 built with parts of their design
    changed, timed in turns against the shipped ones;
  * ``finalize_probe``: the same for kernels 7 and 12, the finalize
    stage's two routes, and (``--split``) their split as a checkout
    calls them.

The probes build their trial builds through ``trials``. Each example runs
on the card unless ``--device cpu`` is given (``kernel_phases`` and the
probes only on a card); its numbers are the device's own.
"""
