"""The plain reference against the port at small widths on the CPU (where
the port runs its kernels' plain versions): one network pass of each model,
and the joint model's first training step, on the same weights and inputs."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import model, weights
from portbench.tests import tiny

ATOM_NF = RESIDUE_NF = 10


def _net_inputs(seed, B=3, NL=8, NP=40):
    g = torch.Generator().manual_seed(seed)
    m_l = (torch.arange(NL)[None] < torch.tensor([[8], [5], [6]])).float()
    m_p = (torch.arange(NP)[None] < torch.tensor([[40], [33], [25]])).float()
    x_l = torch.randn(B, NL, 3, generator=g) * 1.5
    x_p = torch.randn(B, NP, 3, generator=g) * 4.0  # some pairs beyond 5 A
    h_l = torch.randn(B, NL, ATOM_NF, generator=g)
    h_p = torch.eye(RESIDUE_NF)[torch.randint(0, RESIDUE_NF, (B, NP), generator=g)] / 4
    xh_l = torch.cat([x_l, h_l], -1) * m_l[..., None]
    xh_p = torch.cat([x_p, h_p], -1) * m_p[..., None]
    t = torch.rand(B, 1, generator=g)
    return xh_l, xh_p, t, m_l, m_p


@pytest.mark.parametrize("joint", [False, True])
def test_one_network_pass_matches_the_port(joint):
    from diffsbdd_tpu_torch.models.dynamics import EGNNDynamics
    cutoffs = (None, 5.0, 5.0)
    port = EGNNDynamics(ATOM_NF, RESIDUE_NF, joint_nf=8, hidden_nf=16, n_layers=2,
                        attention=True, tanh=True, norm_constant=1, inv_sublayers=1,
                        normalization_factor=100, edge_cutoff_ligand=cutoffs[0],
                        edge_cutoff_pocket=cutoffs[1], edge_cutoff_interaction=cutoffs[2],
                        reflection_equivariant=False, update_pocket_coords=joint,
                        kernel_block_fuse=False)
    leaves = weights.specs(ATOM_NF, RESIDUE_NF, 8, 16, 2)
    # larger weights than the initialisation's, so that every term moves the output
    P = {k: v * 4 for k, v in weights.seeded(leaves, torch.Generator().manual_seed(1),
                                                  "cpu").items()}
    prefix = "ddpm.dynamics."
    port.load_state_dict({k[len(prefix):]: v for k, v in weights.tied_keys(P).items()},
                         strict=True)
    xh_l, xh_p, t, m_l, m_p = _net_inputs(2)
    with torch.no_grad():
        got = port(xh_l, xh_p, t, m_l, m_p)
    net = model.Net(n_layers=2, cutoffs=cutoffs, joint=joint)
    want = model.dynamics(P, net, xh_l, xh_p, t, m_l, m_p)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert scale > 1e-3
        assert float((g - w).abs().max()) <= 2e-5 * scale


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12])
    assert model.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 * 2 ** -10, -3.0]


@pytest.mark.parametrize("cell", [tiny.SAMPLE, tiny.TRAIN])
def test_the_cells_first_stages_match_the_port(cell):
    """The comparisons a run makes, at the small sizes: the program's stages
    and training steps against the reference, far inside the limits."""
    result = tiny.run(cell, seconds=0.5)
    for name, (value, limit) in result["checks"].items():
        assert value <= (limit / 10 if limit else 0), (name, value, limit)


def test_the_seeded_weights_are_the_ports_parameters():
    from diffsbdd_tpu_torch.config import load_config
    from diffsbdd_tpu_torch.train.module import build_module_from_config
    spec, conf, _, _ = tiny.files(tiny.TRAIN)
    cfg = load_config(overrides=conf["config"])
    module = build_module_from_config(cfg, np.ones((10, 50)))
    e = conf["config"]["egnn_params"]
    leaves = weights.specs(10, 10, e["joint_nf"], e["hidden_nf"], e["n_layers"])
    assert [n for n, _, _ in leaves] != []
    assert {n for n, _ in module.named_parameters()} == {n for n, _, _ in leaves}
    for name, p in module.named_parameters():
        shape = dict((n, s) for n, s, _ in leaves)[name]
        assert tuple(p.shape) == tuple(shape)


def test_a_pair_at_its_cutoff_is_borderline_and_its_edge_toggles():
    x0 = torch.tensor([[[0.0, 0, 0], [3.0, 4.0, 0], [0, 0, 1.0], [0, 0, 5.5]]])
    mask = torch.ones(1, 4)
    is_lig = torch.tensor([[1.0, 0, 0, 0]])
    cutoffs = (None, 5.0, 5.0)
    near = model.borderline(x0, mask, is_lig, cutoffs)
    assert near.nonzero().tolist() == [[0, 0, 1]]
    d2 = model.sq_dist(x0)
    adj = model.adjacency(d2, mask, is_lig, cutoffs)
    flip = (near | near.transpose(1, 2)).float()
    toggled = model.adjacency(d2, mask, is_lig, cutoffs, flip)
    assert adj[0, 0, 1] == 1 and toggled[0, 0, 1] == 0 and toggled[0, 1, 0] == 0
    assert torch.equal((toggled != adj), flip.bool())
