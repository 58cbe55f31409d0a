"""Command-line interface.

The JAX package's ``fit`` and ``cleanup`` sub-commands, with the same
options, defaults and choices, and one more option of ``fit``:
``--device`` (``cuda`` by default; ``cpu`` runs the plain PyTorch
versions). A fit raises when CUDA is asked for and absent.

    python -m microstructure_fingerprinting_torch fit \
        --dictionary dic.mat --data dwi.nii.gz --mask mask.nii.gz \
        --numfasc numfasc.nii.gz --peaks peaks.nii.gz \
        --bvals sub.bval --bvecs sub.bvec --csf-mask 1 \
        --out out/subject_mf.nii.gz

    python -m microstructure_fingerprinting_torch cleanup \
        --peakmode tensor --mu1 t0.nii.gz --mu2 t1.nii.gz \
        --frac12 fractions.nii.gz --mask mask.nii.gz --out out/clean

The package is imported only by ``main``, so ``--help`` imports no
torch.
"""

import argparse
import sys


def _mask_arg(v):
    """Scalar or path: '1' -> 1 (all voxels), anything else -> file path."""
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        return v


def _build_parser():
    p = argparse.ArgumentParser(
        prog="microstructure_fingerprinting_torch",
        description="Microstructure fingerprinting in PyTorch on NVIDIA "
                    "GPUs")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fit", help="fit the fingerprinting model")
    f.add_argument("--dictionary", required=True,
                   help=".mat fingerprint dictionary")
    f.add_argument("--data", required=True, help="DWI NIfTI")
    f.add_argument("--mask", required=True, help="ROI mask NIfTI")
    f.add_argument("--numfasc", required=True,
                   help="fascicle-count NIfTI or scalar")
    f.add_argument("--peaks", help="peaks NIfTI (..., 3K)")
    f.add_argument("--colat-longit", nargs="+",
                   help="colatitude/longitude NIfTI(s), one per fascicle")
    f.add_argument("--tensors", nargs="+",
                   help="tensor NIfTI(s), one per fascicle")
    f.add_argument("--pgse-scheme", help="PGSE scheme text file")
    f.add_argument("--bvals", help="b-values text file [s/mm^2]")
    f.add_argument("--bvecs", help="b-vectors text file")
    f.add_argument("--csf-mask", type=_mask_arg, default=None,
                   help="CSF compartment mask NIfTI or scalar 0/1")
    f.add_argument("--ear-mask", type=_mask_arg, default=None,
                   help="EAR compartment mask NIfTI or scalar 0/1")
    f.add_argument("--out", required=True,
                   help="output basename (one NIfTI per parameter map)")
    f.add_argument("--verbose", type=int, default=2)
    f.add_argument("--parallel", action="store_true",
                   help="shard voxel batches over all devices (fits on one "
                        "device; several raise NotImplementedError)")
    f.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "fast", "pallas"],
                   help="device scan: 'fast' = double-float fast path "
                        "('pallas' is a legacy alias), 'xla' = general "
                        "tiled scan, 'auto' picks per configuration")
    f.add_argument("--batch-size", type=int, default=None)
    f.add_argument("--topm", type=int, default=16,
                   help="float64 refinement candidate budget")
    f.add_argument("--save-tables",
                   help="persist the precomputed interpolation tables (.npz)")
    f.add_argument("--device", default="cuda",
                   help="torch device of the fit ('cuda' by default; 'cpu' "
                        "runs the plain PyTorch versions)")

    c = sub.add_parser("cleanup", help="clean up detected fascicle peaks")
    c.add_argument("--peakmode", required=True,
                   choices=["colat_longit", "peaks", "tensor"])
    c.add_argument("--mu1", required=True)
    c.add_argument("--mu2", required=True)
    c.add_argument("--mask", required=True)
    c.add_argument("--frac1")
    c.add_argument("--frac2")
    c.add_argument("--frac12")
    c.add_argument("--out", required=True,
                   help="output basename for _peaks and _numfasc NIfTIs")
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)
    # imports deferred so `--help` stays instant
    from .models.mf import MFModel, cleanup_2fascicles
    from .utils import nifti

    if args.cmd == "fit":
        model = MFModel(args.dictionary, device=args.device)
        if args.save_tables:
            model.ms_interpolator.save(args.save_tables)
        fit = model.fit(
            args.data, args.mask, _mask_arg(args.numfasc),
            peaks=args.peaks,
            colat_longit=args.colat_longit,
            tensors=args.tensors,
            pgse_scheme=args.pgse_scheme,
            bvals=args.bvals, bvecs=args.bvecs,
            csf_mask=args.csf_mask, ear_mask=args.ear_mask,
            verbose=args.verbose, parallel=args.parallel,
            batch_size=args.batch_size, topm=args.topm,
            engine=args.engine)
        files = fit.write_nifti(args.out)
        if args.verbose >= 1:
            print("Wrote %d parameter maps:" % len(files))
            for fn in files:
                print("  %s" % fn)
        return 0

    if args.cmd == "cleanup":
        peaks, numfasc = cleanup_2fascicles(
            args.frac1, args.frac2, args.peakmode, args.mu1, args.mu2,
            args.mask, frac12=args.frac12)
        mask_img = nifti.load(args.mask)
        ext = ".nii.gz" if args.out.endswith(".nii.gz") else ".nii"
        base = args.out[:-len(ext)] if args.out.endswith(ext) else args.out
        p1 = nifti.save(nifti.Nifti1Image(peaks, mask_img.affine),
                        base + "_peaks" + ext)
        p2 = nifti.save(nifti.Nifti1Image(numfasc, mask_img.affine),
                        base + "_numfasc" + ext)
        print("Wrote %s and %s" % (p1, p2))
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
