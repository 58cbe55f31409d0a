"""The acquisition scheme, the fingerprint dictionary and the fixed
compartments' signatures of a configuration, built from its file.

Frozen plain copies, so that the yardstick does not move with the
program: the dense multi-shell scheme and the smooth zeppelin dictionary
of the port's ``testing.make_dense_scheme`` / ``make_dictionary``, and
the CSF and EAR signatures that ``MFModel.fit`` builds from the
dictionary's ``T2_csf``/``DIFF_csf`` and ``T2_ear``/``DIFF_ear``
(reference mf.py:922-934). Everything is float64 NumPy on the host.
"""

import numpy as np

#: gyromagnetic ratio of 1H [rad/s/T] (reference mf_utils.py:1138-1150)
GAMMA_H = 2.0 * np.pi * 42.577480e6


def fibonacci_sphere(n):
    """n roughly uniform unit directions (golden-angle spiral)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=1)


def dense_scheme(n_shells, dirs_per_shell, n_b0, G_max, Delta, delta, TE):
    """PGSE scheme (rows [gx, gy, gz, G, Delta, delta, TE], SI): a block
    of ``n_b0`` b0 rows, then ``n_shells`` shells of ``dirs_per_shell``
    directions at G = G_max (s + 1) / n_shells."""
    rows = [np.zeros((n_b0, 7))]
    rows[0][:, 4:7] = [Delta, delta, TE]
    for s in range(n_shells):
        sh = np.zeros((dirs_per_shell, 7))
        sh[:, :3] = fibonacci_sphere(dirs_per_shell)
        sh[:, 3] = G_max * (s + 1) / n_shells
        sh[:, 4:7] = [Delta, delta, TE]
        rows.append(sh)
    return np.concatenate(rows, axis=0)


def b_values(sch):
    """b = (gamma G delta)^2 (Delta - delta / 3) of each row [s/m^2]."""
    return (GAMMA_H * sch[:, 3] * sch[:, 5]) ** 2 * (sch[:, 4]
                                                     - sch[:, 5] / 3)


def zeppelin_grid(num_atom, d_par_range, d_perp_range):
    """(d_par, d_perp) of each atom: the first ``num_atom`` points of a
    ceil(sqrt(num_atom))^2 grid, d_par the slow axis."""
    n = int(np.ceil(np.sqrt(num_atom)))
    dp, dq = np.meshgrid(np.linspace(*d_par_range, n),
                         np.linspace(*d_perp_range, n), indexing="ij")
    return dp.ravel()[:num_atom], dq.ravel()[:num_atom]


def zeppelins(sch, d_par, d_perp, cos2):
    """Zeppelin signals exp(-b (d_perp + (d_par - d_perp) cos^2)) with
    ``cos2`` (S,) or broadcastable the squared cosine between each row's
    gradient and the fascicle: (S, atoms)."""
    b = b_values(sch)
    return np.exp(-b[:, None] * (d_perp[None, :] + (d_par - d_perp)[None, :]
                                 * np.reshape(cos2, (-1, 1))))


def scheme(cfg):
    return dense_scheme(**cfg["scheme"])


def csf_signature(cfg, sch):
    """(S,) free-water signature exp(-TE / T2_csf) exp(-b D_csf)."""
    return (np.exp(-sch[:, 6] / cfg["T2_csf"])
            * np.exp(-b_values(sch) * cfg["DIFF_csf"]))


def ear_diffusivities(cfg):
    if not cfg.get("num_ear"):
        return np.zeros(0)
    return np.linspace(*cfg["DIFF_ear_range"], cfg["num_ear"])


def ear_signatures(cfg, sch):
    """(S, E) EAR signatures exp(-TE / T2_ear) exp(-b D_e); E = 0
    without EAR atoms."""
    D = ear_diffusivities(cfg)
    if not D.size:
        return np.zeros((sch.shape[0], 0))
    return (np.exp(-sch[:, 6] / cfg["T2_ear"])[:, None]
            * np.exp(-b_values(sch)[:, None] * D[None, :]))


def build(cfg):
    """(scheme, dictionary for ``MFModel``) of configuration ``cfg``.

    The dictionary's atoms are the zeppelins along ``orientation``; its
    per-atom properties are d_par, d_perp and the atom's own index
    (``atom_id``), so that the fit's property maps name the chosen atom
    of each fascicle exactly."""
    sch = scheme(cfg)
    d_par, d_perp = zeppelin_grid(cfg["num_atom"], cfg["d_par_range"],
                                  cfg["d_perp_range"])
    ori = np.asarray(cfg["orientation"], dtype=np.float64)
    gnorm = np.linalg.norm(sch[:, :3], axis=1)
    cos = np.where(gnorm > 0, sch[:, :3] @ ori / np.where(gnorm > 0, gnorm,
                                                            1.0), 0.0)
    dic = {
        "dictionary": zeppelins(sch, d_par, d_perp, cos ** 2),
        "sch_mat": sch, "orientation": ori, "num_atom": cfg["num_atom"],
        "fasc_propnames": ["d_par", "d_perp", "atom_id"],
        "d_par": d_par, "d_perp": d_perp,
        "atom_id": np.arange(cfg["num_atom"], dtype=np.float64),
        "T2_csf": cfg["T2_csf"], "DIFF_csf": cfg["DIFF_csf"],
    }
    if cfg.get("num_ear"):
        dic.update(num_ear=cfg["num_ear"], T2_ear=cfg["T2_ear"],
                   DIFF_ear=ear_diffusivities(cfg))
    return sch, dic
