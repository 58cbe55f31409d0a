"""Flat compatibility namespace mirroring the reference's ``mf_utils``.

Reference users do ``from microstructure_fingerprinting import mf_utils as
mfu`` and call a flat catalogue of solvers, DW-MRI ops, simulators, plotting
and I/O helpers (reference mf_utils.py:73-102 name registry). This module
holds the names of ``microstructure_fingerprinting_tpu.mf_utils``, drawn
from this package, so that existing scripts port with an import change
only; ``gen_sos_mri_torch`` (an explicit ``torch.Generator``) stands
where the JAX package has ``gen_sos_mri_jax`` (a PRNG key). The batched
``exhaustive_*`` solvers take torch tensors; the functions that do
device work take ``device=``, the card by default.
"""

# SOLVERS (reference registry mf_utils.py:73-79)
from .ops.nnls import (                                     # noqa: F401
    solve_exhaustive_posweights,
    solve_exhaustive_posweights_1,
    solve_exhaustive_posweights_2,
    solve_exhaustive_posweights_3,
    solve_exhaustive_posweights_4up,
    lsqnonneg_2var_opt,
    nnls_underdetermined,
    lsqnonneg_1var,
    lsqnonneg_2var,
    lsqnonneg_3var,
    lsqnonneg_4var,
    exhaustive_nnls_blocks,
    exhaustive_1_batched,
    exhaustive_2_batched,
    exhaustive_3_batched,
    exhaustive_4_batched,
)

# MATH TOOLS (mf_utils.py:80-82)
from .ops.math3d import (                                   # noqa: F401
    get_perp_vector,
    rotate_vector,
    vrrotvec2mat,
    rotate_scheme_mat,
)

# DW-MRI (mf_utils.py:83-96)
from .ops.dti import (                                      # noqa: F401
    DT_array_to_vec,
    DT_vec_to_2Darray,
    DT_vec_to_peaks,
    peaks_to_DT_vec,
)
from .utils.scheme import (                                 # noqa: F401
    get_gyromagnetic_ratio,
    import_PGSE_scheme,
    get_PGSE_scheme_from_bval_bvec_dense,
    project_PGSE_scheme_xy_plane,
    b_values,
)
from .ops.interp import (                                   # noqa: F401
    rotate_atom,
    rotate_atom_2Dprotocol,
    interp_PGSE_from_multishell,
    init_PGSE_multishell_interp,
    plan_target_scheme,
    eval_rotation,
    MultiShellInterp,
)
from .ops.noise import gen_SoS_MRI, gen_sos_mri_torch       # noqa: F401

# DW-MRI VISUALIZATION (mf_utils.py:97-98)
from .viz import (                                          # noqa: F401
    plot_multi_shell_signal,
    plot_signal_2Dprotocol,
)

# MONTE CARLO (mf_utils.py:99-100)
from .ops.mc import (                                       # noqa: F401
    monte_carlo_average,
    get_PGSE_from_phases,
)

# I/O (mf_utils.py:101-102)
from .utils.io import loadmat, from_ipython                 # noqa: F401
