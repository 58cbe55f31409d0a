"""DW-MRI signal visualization (host-side matplotlib).

The JAX package's ``viz.py``: ``plot_multi_shell_signal`` (reference
mf_utils.py:2362-2617) and ``plot_signal_2Dprotocol`` (mf_utils.py:
2620-2752). Matplotlib is optional and is imported when a plotter runs,
not with this module; without it ``pyplot`` is a :class:`TripWire` and a
plotter trips on first use.
"""

import numpy as np

from .tripwire import TripWire
from .utils.scheme import get_gyromagnetic_ratio, load_scheme_text
from .utils.scheme import import_PGSE_scheme


def pyplot():
    """``matplotlib.pyplot``, or a :class:`TripWire` without matplotlib."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return TripWire('Importing matplotlib.pyplot raised an ImportError.')
    return plt


def plot_multi_shell_signal(sig, sch_mat, fascdir,
                            plot_distr=None, substrate_names=None):
    """Plot S vs |g.n| per (G, Delta, delta) shell, one axes per substrate
    group, paged 2x3 subplots per figure.

    Args:
      sig: (num_seq,) or (num_seq, num_subs) signals.
      sch_mat: (num_seq, >=6) scheme array or path to a scheme file.
      fascdir: (3,) common fascicle direction or (3, num_subs).
      plot_distr: list of lists of substrate indices per axes (default: one
        axes per substrate).
      substrate_names: legend names (str or list).
    """
    gam = get_gyromagnetic_ratio('H')
    if np.ndim(sig) < 2:
        sig = np.reshape(sig, (np.size(sig), 1))
    num_subs = sig.shape[1]

    if isinstance(sch_mat, str):
        sch_mat = load_scheme_text(sch_mat)
    if np.ndim(sch_mat) != 2:
        raise ValueError('Argument sch_mat should be a 2-D NumPy array, '
                         'detected %d dimensions.' % np.ndim(sch_mat))
    if sch_mat.shape[1] < 6:
        raise ValueError('Argument sch_mat should be a 2-D array (or a '
                         'path to a file) containing at least 6 columns,'
                         ' detected %d columns here.' % sch_mat.shape[1])
    if sch_mat.shape[0] != sig.shape[0]:
        raise ValueError('Argument sch_mat should have as many rows as '
                         'sig.shape[0] (=%d). Detected %d.'
                         % (sig.shape[0], sch_mat.shape[0]))
    Gdir_norm = np.sqrt(np.sum(sch_mat[:, :3] ** 2, axis=1))
    if np.any(~np.isclose(Gdir_norm[Gdir_norm > 0], 1)):
        raise ValueError('Argument sch_mat: the first three columns should'
                         'define unit vectors or optionally zero vectors '
                         'for non diffusion-weighted signals.')

    fascdir = np.asarray(fascdir, dtype=np.float64)
    if np.ndim(fascdir) < 2:
        fascdir = np.reshape(fascdir, (fascdir.shape[0], 1))
    if fascdir.shape[0] != 3:
        raise ValueError('Argument fascdir should contain column(s) with '
                         '3 elements, detected %d.' % fascdir.shape[0])
    norms = np.sqrt(np.sum(fascdir ** 2, axis=0))
    if np.any(~np.isclose(norms, 1)):
        raise ValueError('Argument fascdir: fascicle direction(s) should be '
                         'unit column vector(s). Detected %d non-normalized'
                         ' orientation(s).' % np.sum(~np.isclose(norms, 1)))
    if fascdir.shape[1] == 1:
        fascdir = np.tile(fascdir, (1, num_subs))
    elif fascdir.shape[1] != num_subs:
        raise ValueError('Argument fascdir, if more than 1-column wide,'
                         ' should contain as many columns as there are '
                         'substrates to plot. Detected %d instead of %d.'
                         % (fascdir.shape[1], num_subs))

    if not plot_distr:
        plot_distr = [[isub] for isub in range(num_subs)]
    num_axes = len(plot_distr)
    for i in range(num_axes):
        if np.any(np.atleast_1d(plot_distr[i]) >= num_subs):
            raise ValueError('In plot_distr[%d], detected substrate '
                             'indice(s) equal to or exceeding num_subs-1'
                             ' (=%d).' % (i, num_subs - 1))

    if substrate_names is None:
        substrate_names = ["sub %d" % (i + 1,) for i in range(num_subs)]
    if isinstance(substrate_names, str):
        if num_subs == 1:
            substrate_names = [substrate_names]
        else:
            raise ValueError('Argument substrate_names should be a list of '
                             'strings and can only be a simple string if '
                             'num_subs=1, but detected num_subs=%d'
                             % num_subs)
    if len(substrate_names) != num_subs:
        raise ValueError('Number of labels in substrate_names (%d) does'
                         ' not match number of substrates to be '
                         'plotted (%d).' % (len(substrate_names), num_subs))

    bvals = (gam * sch_mat[:, 3] * sch_mat[:, 5]) ** 2 \
        * (sch_mat[:, 4] - sch_mat[:, 5] / 3)
    GdD_un, i_sh = np.unique(sch_mat[:, 3:6], return_inverse=True, axis=0)
    shell_b = np.array([bvals[i_sh == s][0] for s in range(GdD_un.shape[0])])
    order = np.argsort(shell_b)
    counts = np.array([np.sum(i_sh == s) for s in range(GdD_un.shape[0])])
    keep = [s for s in order if counts[s] >= 2 or shell_b[s] == 0]
    n_skip = GdD_un.shape[0] - len(keep)
    if n_skip > 0:
        print("WARNING: ignoring %d shell(s) containing fewer than 2 data"
              " point(s)." % n_skip)

    plt = pyplot()
    m_sp, n_sp = 2, 3
    markers = 'o+*xsd^v><ph'
    lstyles = ['-', '--', ':', '-.']
    ax_grid = None
    figs = []
    for iaxes in range(num_axes):
        sub_id = iaxes % (m_sp * n_sp)
        if sub_id == 0:
            fig, ax_grid = plt.subplots(nrows=m_sp, ncols=n_sp,
                                        squeeze=False, sharex=True,
                                        sharey=True)
            figs.append(fig)
        ax = ax_grid[sub_id // n_sp, sub_id % n_sp]
        for j, isub in enumerate(np.atleast_1d(plot_distr[iaxes])):
            for si, s in enumerate(keep):
                ind = i_sh == s
                dots = np.abs(sch_mat[ind, :3] @ fascdir[:, isub])
                srt = np.argsort(dots)
                label = None
                if si == 0 or j == 0:
                    label = ("%s b=%d" % (substrate_names[isub],
                                          round(shell_b[s] / 1e6))
                             if len(np.atleast_1d(plot_distr[iaxes])) > 1
                             else "b=%d G=%.3g" % (round(shell_b[s] / 1e6),
                                                   GdD_un[s, 0]))
                ax.plot(dots[srt], sig[ind, isub][srt],
                        linestyle=lstyles[j % len(lstyles)],
                        marker=markers[j % len(markers)], fillstyle='none',
                        color='C%d' % (si % 10,), label=label)
        ax.set_xlabel('|g.n|')
        ax.set_ylabel('S')
        ax.legend(loc='best', fontsize='x-small')
    return figs


def plot_signal_2Dprotocol(sig, scheme, display_names=None):
    """Plot AxCaliber-like signals: per (Delta, delta) pair, S vs signed G
    along each acquisition line, 3 pairs per figure, b0 cluster at G=0."""
    sch_mat = import_PGSE_scheme(scheme)
    if np.any(sch_mat[:, 2] != 0):
        raise ValueError("Use the original schemefile with zeros for gz")
    sig = np.asarray(sig)
    if sig.ndim == 1:
        sig = sig[:, np.newaxis]
    elif sig.ndim > 2:
        raise ValueError("sig should be a 1D or 2D NumPy array, detected"
                         " %d dimensions." % sig.ndim)
    if sig.shape[0] != sch_mat.shape[0]:
        raise ValueError("Mismatch: detected %d values in signal(s) to plot"
                         "versus %d sequences in acquisition protocol."
                         % (sig.shape[0], sch_mat.shape[0]))
    numsubs = sig.shape[1]
    if display_names is None:
        display_names = ["sub %d " % (i,) for i in range(numsubs)]

    plt = pyplot()
    fig_per_plt = 3
    lstyles = ['-', '--', '-.', ':']
    cmap = plt.get_cmap('Set1')(np.linspace(0, 1, 8))

    Gxy = sch_mat[:, 3]
    gdir_xy = sch_mat[:, :3]
    Deldel_un, i_un = np.unique(sch_mat[:, 4:6], return_inverse=True, axis=0)
    num_Deldels = Deldel_un.shape[0]
    max_sig = np.max(sig)
    figs = []
    ax_row = None
    for idel in range(num_Deldels):
        if idel % fig_per_plt == 0:
            fig, ax_row = plt.subplots(1, fig_per_plt, sharey=True)
            figs.append(fig)
            ax_row[0].set_ylim(top=max_sig)
        ax = ax_row[idel % fig_per_plt]
        ind_del = np.where(i_un == idel)[0]
        gdir_un, ig_un = np.unique(sch_mat[ind_del, :3],
                                   return_inverse=True, axis=0)
        cross_dp = gdir_un @ gdir_un.T
        ig, ig_op = np.where(np.isclose(cross_dp, -1))
        is_upper = ig < ig_op
        ig, ig_op = ig[is_upper], ig_op[is_upper]
        label_deltas = "Del=%gs del=%gs" % (Deldel_un[idel, 0] * 1e3,
                                            Deldel_un[idel, 1] * 1e3)
        for isub in range(numsubs):
            sig_b0 = sig[ind_del, isub][Gxy[ind_del] == 0]
            ax.plot(np.zeros(sig_b0.shape), sig_b0, marker='x',
                    color=cmap[isub % len(cmap)],
                    label=('b0 (%s)' % label_deltas) if isub == 0 else None)
        for isub in range(numsubs):
            col = cmap[isub % len(cmap)]
            for idir in range(ig.size):
                linedir = gdir_un[ig[idir]]
                indline = ind_del[(ig_un == ig[idir])
                                  | (ig_un == ig_op[idir])]
                G_signed = Gxy[indline] * np.sign(
                    gdir_xy[indline, :] @ linedir)
                srt = np.argsort(G_signed)
                label = None
                if idir == 0:
                    label = display_names[isub]
                ax.plot(G_signed[srt], sig[indline, isub][srt], marker='.',
                        color=col, linestyle=lstyles[idir % len(lstyles)],
                        label=label)
        ax.legend(fontsize='x-small')
        ax.grid()
        ax.set_xlabel("signed G")
    return figs
