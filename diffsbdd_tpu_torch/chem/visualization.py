"""Sample visualization: xyz dumps, matplotlib ball-and-stick renders and
denoising-chain GIFs, with optional wandb logging.

matplotlib (the Agg backend) and imageio are imported inside the functions
that render, so that writing xyz files needs neither.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from diffsbdd_tpu_torch.chem.molecule import get_bond_order_batch
from diffsbdd_tpu_torch.chem.sdfio import (load_molecule_xyz, load_xyz_files,
                                           write_xyz_file)


def save_xyz_file(path, one_hot, positions, atom_decoder, name="molecule",
                  batch_mask=None):
    """One xyz file ``<name>_<graph:03d>.txt`` a graph of a flat batch
    (``batch_mask``: the graph index of every node; one graph without it)."""
    Path(path).mkdir(parents=True, exist_ok=True)
    one_hot = np.asarray(one_hot)
    positions = np.asarray(positions)
    if batch_mask is None:
        batch_mask = np.zeros(len(positions), dtype=int)
    batch_mask = np.asarray(batch_mask).astype(int)
    for batch_i in np.unique(batch_mask):
        sel = batch_mask == batch_i
        types = [atom_decoder[i] for i in one_hot[sel].argmax(-1)]
        write_xyz_file(positions[sel], types,
                       Path(path, f"{name}_{batch_i:03d}.txt"))


def plot_molecule(ax, positions, atom_types, dataset_info, alpha=1.0,
                  spheres_3d=False, hex_bg_color="#FFFFFF"):
    """Ball-and-stick render onto a 3D matplotlib axis: atoms coloured and
    sized by type, EDM bonds as lines whose width grows with the order."""
    colors_dic = np.array(dataset_info["colors_dic"])
    radius_dic = np.array(dataset_info["radius_dic"])
    area_dic = 1500 * radius_dic ** 2

    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    areas = area_dic[atom_types]
    colors = colors_dic[atom_types]

    # the bond orders of all pairs in one vectorized call
    n = len(positions)
    ii, jj = np.triu_indices(n, k=1)
    if len(ii):
        dists = np.linalg.norm(positions[ii] - positions[jj], axis=1)
        orders = get_bond_order_batch(
            np.asarray(atom_types)[ii], np.asarray(atom_types)[jj],
            dists, dataset_info)
        line_color = "#FFFFFF" if hex_bg_color == "#000000" else "#666666"
        for i, j, order in zip(ii, jj, orders):
            if order > 0:
                ax.plot([x[i], x[j]], [y[i], y[j]], [z[i], z[j]],
                        linewidth=(3 - 2) * 2 * 0.7 + int(order) * 0.7,
                        c=line_color, alpha=alpha)
    ax.scatter(x, y, z, s=areas, alpha=0.9 * alpha, c=colors)


def plot_data3d(positions, atom_types, dataset_info, save_path=None,
                spheres_3d=False, bg="#FFFFFF", alpha=1.0, camera_elev=0,
                camera_azim=0):
    """Render one molecule to ``save_path`` (PNG, 120 dpi), or show it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.set_aspect("auto")
    ax.view_init(elev=camera_elev, azim=camera_azim)
    ax.set_facecolor(bg)
    ax.xaxis.pane.set_alpha(0)
    ax.yaxis.pane.set_alpha(0)
    ax.zaxis.pane.set_alpha(0)
    ax.set_axis_off()

    plot_molecule(ax, positions, atom_types, dataset_info, alpha=alpha,
                  spheres_3d=spheres_3d, hex_bg_color=bg)

    max_value = np.abs(positions).max() if len(positions) else 1.0
    axis_lim = min(40, max(max_value / 1.5 + 0.3, 3.2))
    ax.set_xlim(-axis_lim, axis_lim)
    ax.set_ylim(-axis_lim, axis_lim)
    ax.set_zlim(-axis_lim, axis_lim)

    if save_path is None:
        plt.show()
    else:
        plt.savefig(save_path, bbox_inches="tight", pad_inches=0.0, dpi=120)
    plt.close(fig)


def visualize(path, dataset_info, max_num=25, wandb=None, spheres_3d=False):
    """Render up to ``max_num`` xyz files of a directory, each to a PNG beside
    it; with ``wandb`` (the module) log each image."""
    files = load_xyz_files(path)[:max_num]
    for file in files:
        positions, one_hot = load_molecule_xyz(file, dataset_info["atom_encoder"])
        out = str(file)[:-4] + ".png"
        plot_data3d(positions, one_hot.argmax(-1), dataset_info, save_path=out,
                    spheres_3d=spheres_3d)
        if wandb is not None:
            wandb.log({"molecule": wandb.Image(out)})


def visualize_chain(path, dataset_info, wandb=None, spheres_3d=False,
                    mode="chain"):
    """Render a denoising trajectory's xyz frames (in file order) to PNGs and
    one GIF, ``output_<mode>.gif``; returns the GIF's path, or None without
    frames."""
    files = load_xyz_files(path, shuffle=False)
    save_paths = []
    for file in files:
        positions, one_hot = load_molecule_xyz(file, dataset_info["atom_encoder"])
        out = str(file)[:-4] + ".png"
        plot_data3d(positions, one_hot.argmax(-1), dataset_info, save_path=out,
                    spheres_3d=spheres_3d)
        save_paths.append(out)

    if not save_paths:
        return None
    import imageio
    gif_path = str(Path(path, f"output_{mode}.gif"))
    imgs = [imageio.v2.imread(fn) for fn in save_paths]
    imageio.mimsave(gif_path, imgs, subrectangles=True)
    if wandb is not None:
        wandb.log({mode: wandb.Video(gif_path, fps=4, format="gif")})
    return gif_path
