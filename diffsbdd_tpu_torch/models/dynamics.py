"""The epsilon-network: encoders + EGNN over the joint ligand/pocket graph.

In the conditional models the pocket coordinates stay fixed
(``update_pocket_coords=False``); in the joint model every node moves and the
velocity field's centre of mass is removed.  The network is conditioned on
time.  Inputs are padded per-domain tensors; the
node axes are concatenated ligand-first inside:
  xh_lig: (B, NL, 3 + atom_nf)      mask_lig: (B, NL)
  xh_pkt: (B, NP, 3 + residue_nf)   mask_pkt: (B, NP)
  t:      (B, 1) normalized time
Returns (eps_lig, eps_pkt) with the same leading shapes.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diffsbdd_tpu_torch.models.egnn import EGNN, GraphContext
from diffsbdd_tpu_torch.ops.masked import masked_mean


def _mlp2(d_in: int, d_mid: int, d_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, d_mid), nn.SiLU(), nn.Linear(d_mid, d_out))


class EGNNDynamics(nn.Module):
    """Predicts (eps_x, eps_h) for ligand and pocket nodes."""

    def __init__(self, atom_nf: int, residue_nf: int, joint_nf: int = 16,
                 hidden_nf: int = 64, n_layers: int = 4,
                 attention: bool = False, tanh: bool = False,
                 norm_constant: float = 0.0, inv_sublayers: int = 2,
                 normalization_factor: float = 100.0,
                 edge_cutoff_ligand: Optional[float] = None,
                 edge_cutoff_pocket: Optional[float] = None,
                 edge_cutoff_interaction: Optional[float] = None,
                 reflection_equivariant: bool = True,
                 edge_embedding_dim: Optional[int] = None,
                 update_pocket_coords: bool = False,
                 kernel_block_fuse: bool = False):
        super().__init__()
        self.update_pocket_coords = update_pocket_coords
        # allow the whole-block kernel where a caller asks for it (the
        # samplers do); False: always the split kernels
        self.kernel_block_fuse = kernel_block_fuse
        self.inv_sublayers = inv_sublayers
        self.cutoffs = (edge_cutoff_ligand, edge_cutoff_pocket,
                        edge_cutoff_interaction)
        self.atom_encoder = _mlp2(atom_nf, 2 * atom_nf, joint_nf)
        self.atom_decoder = _mlp2(joint_nf, 2 * atom_nf, atom_nf)
        self.residue_encoder = _mlp2(residue_nf, 2 * residue_nf, joint_nf)
        self.residue_decoder = _mlp2(joint_nf, 2 * residue_nf, residue_nf)
        # learnable 3-way edge-type embedding: 0 = cross, 1 = lig-lig,
        # 2 = pkt-pkt
        self.edge_embedding = nn.Embedding(3, edge_embedding_dim) \
            if edge_embedding_dim is not None else None
        dyn_nf = joint_nf + 1  # + the time channel
        self.egnn = EGNN(
            in_node_nf=dyn_nf, hidden_nf=hidden_nf, out_node_nf=dyn_nf,
            in_edge_nf=edge_embedding_dim or 0, n_layers=n_layers,
            attention=attention, tanh=tanh, norm_constant=norm_constant,
            inv_sublayers=inv_sublayers,
            normalization_factor=normalization_factor,
            reflection_equiv=reflection_equivariant)

    def forward(self, xh_lig, xh_pkt, t, mask_lig, mask_pkt,
                shared_pocket: bool = False, zero_nan: bool = False,
                block_fuse: bool = False, shard=None):
        """``block_fuse``: run one-GCL blocks as the whole-block kernel (the
        samplers ask for it; it takes effect when ``kernel_block_fuse`` is
        set).  ``shared_pocket``: the batch holds one pocket replicated across
        samples and ``t`` is uniform over the batch, which lets the first GCL
        compute its pocket-pocket aggregation once.  ``zero_nan``: the
        training-time guard -- NaN velocities become zeros (and infinities the
        largest finite values), so one numerical blow-up corrupts a step
        instead of poisoning the parameters.  In the joint model no pocket
        is shared: every node diffuses.  ``shard``: this rank's column block
        under edge-axis sharding (``parallel.edge_shard.ShardContext``; its
        callers go through ``edge_sharded_dynamics``); it turns the shared
        pocket and block fusing off, since both need every column at once."""
        B, NL = mask_lig.shape
        NP = mask_pkt.shape[1]
        nd = 3
        x_lig, h_lig = xh_lig[..., :nd], xh_lig[..., nd:]
        x_pkt, h_pkt = xh_pkt[..., :nd], xh_pkt[..., nd:]

        h = torch.cat([self.atom_encoder(h_lig), self.residue_encoder(h_pkt)], 1)
        x = torch.cat([x_lig, x_pkt], dim=1)
        mask = torch.cat([mask_lig, mask_pkt], dim=1)
        is_lig = torch.cat([torch.ones_like(mask_lig), torch.zeros_like(mask_pkt)], 1)
        h = torch.cat([h, t[:, None, :].expand(B, NL + NP, 1).to(h.dtype)], -1)

        type_table = None if self.edge_embedding is None \
            else self.edge_embedding.weight
        ctx = GraphContext(
            x0=x, mask=mask, is_lig=is_lig, cutoffs=self.cutoffs,
            type_table=type_table, n_lig=NL,
            update_rows=None if self.update_pocket_coords else NL,
            block_fuse=bool(block_fuse) and self.kernel_block_fuse
            and self.inv_sublayers == 1 and shard is None, shard=shard)
        h_final, x_final = self.egnn(
            h, x, ctx, shared_pocket=bool(shared_pocket) and not self.update_pocket_coords
            and shard is None)
        vel = (x_final - x) * mask[..., None]
        if zero_nan:
            vel = torch.nan_to_num(vel)
        if self.update_pocket_coords:
            # the joint model removes the velocity field's centre of mass
            vel = (vel - masked_mean(vel, mask)[:, None, :]) * mask[..., None]

        h_final = h_final[..., :-1]  # drop the time channel
        h_final_lig = self.atom_decoder(h_final[:, :NL])
        h_final_pkt = self.residue_decoder(h_final[:, NL:])

        eps_lig = torch.cat([vel[:, :NL], h_final_lig * mask_lig[..., None]], -1)
        eps_pkt = torch.cat([vel[:, NL:], h_final_pkt * mask_pkt[..., None]], -1)
        return eps_lig, eps_pkt
