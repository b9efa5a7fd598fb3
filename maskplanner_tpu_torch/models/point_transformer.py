"""The transformer encoder-decoder baseline
(``maskplanner_tpu/models/point_transformer.py``).

A small encoder over the unordered input segments and a causal decoder
with cross-attention over the ordered pose sequence, sinusoidal positions,
a pose head and an end-of-sequence head. With target poses the forward is
teacher forcing (a zero start pose prepended); without, it decodes
``max_seq_len`` steps autoregressively, each step decoding the whole
sequence again under the causal mask, as the JAX package's scan does.

The attention is Flax's ``MultiHeadDotProductAttention`` in plain PyTorch:
query, key, value and output projections with biases, the query scaled by
1/sqrt(head_dim), masked scores at the dtype's least value; each
LayerNorm takes Flax's epsilon, 1e-6.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

LAYER_NORM_EPS = 1e-6   # Flax's nn.LayerNorm


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    i = np.arange(0, d_model, 2)[None, :]
    rates = 1.0 / (10000 ** (i / d_model))
    enc = np.zeros((max_len, d_model), np.float32)
    enc[:, 0::2] = np.sin(pos * rates)
    enc[:, 1::2] = np.cos(pos * rates)
    return enc


class Attention(nn.Module):
    """Multi-head dot-product attention with Flax's projections: ``query``,
    ``key``, ``value`` (d -> heads·head_dim) and ``out`` (heads·head_dim ->
    d)."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, Lq, d) attends to memory (B, Lk, d); ``mask`` (Lq, Lk),
        True where attention is allowed."""
        B, Lq, d = x.shape
        H = self.heads
        q = self.query(x).reshape(B, Lq, H, d // H) / math.sqrt(d // H)
        k = self.key(memory).reshape(B, -1, H, d // H)
        v = self.value(memory).reshape(B, -1, H, d // H)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v)
                        .reshape(B, Lq, d))


class TransformerLayer(nn.Module):
    """Post-norm layer: self-attention, with ``cross`` attention to the
    memory, then the ReLU feed-forward (``ff.0``, ``ff.1``), each added
    to its input and normalised (``norms.{k}``)."""

    def __init__(self, d_model: int, heads: int, dim_feedforward: int,
                 cross: bool = False):
        super().__init__()
        self.self_attn = Attention(d_model, heads)
        self.cross_attn = Attention(d_model, heads) if cross else None
        self.ff = nn.ModuleList([nn.Linear(d_model, dim_feedforward),
                                 nn.Linear(dim_feedforward, d_model)])
        self.norms = nn.ModuleList(
            nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
            for _ in range(3 if cross else 2))

    def forward(self, x, memory=None, mask=None):
        x = self.norms[0](x + self.self_attn(x, x, mask))
        if self.cross_attn is not None:
            x = self.norms[1](x + self.cross_attn(x, memory))
        h = self.ff[1](torch.relu(self.ff[0](x)))
        return self.norms[-1](x + h)


# the attention's head count, as the JAX module's ``nhead`` default; the
# weight converter splits the attention kernels by it
ATTENTION_HEADS = 4


class PointTransformer(nn.Module):
    """Encoder-decoder: with ``tgt_points`` teacher forcing, without
    autoregressive decoding. Both give ``(points (B, L, outdim),
    end-of-sequence probabilities (B, L, 1))``."""

    def __init__(self, d_model: int = 64, nhead: int = ATTENTION_HEADS,
                 num_layers: int = 2, dim_feedforward: int = 256,
                 max_seq_len: int = 100, input_dim: int = 3,
                 outdim: int = 6, weight_orient: float = 1.0):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.outdim = outdim
        self.weight_orient = weight_orient
        self.segments_embedding = nn.Linear(input_dim, d_model)
        self.points_embedding = nn.Linear(outdim, d_model)
        self.encoder_layers = nn.ModuleList(
            TransformerLayer(d_model, nhead, dim_feedforward)
            for _ in range(num_layers))
        self.decoder_layers = nn.ModuleList(
            TransformerLayer(d_model, nhead, dim_feedforward, cross=True)
            for _ in range(num_layers))
        self.output_layer = nn.Linear(d_model, outdim)
        self.eos_layer = nn.Linear(d_model, 1)
        self.register_buffer("pos_enc", torch.from_numpy(
            sinusoidal_positions(max_seq_len + 1, d_model)),
            persistent=False)

    def encode(self, src_points: torch.Tensor) -> torch.Tensor:
        x = self.segments_embedding(src_points)
        for layer in self.encoder_layers:
            x = layer(x)
        return x

    def decode(self, tgt_emb: torch.Tensor,
               memory: torch.Tensor) -> torch.Tensor:
        L = tgt_emb.shape[1]
        mask = torch.ones(L, L, dtype=torch.bool,
                          device=tgt_emb.device).tril()
        x = tgt_emb
        for layer in self.decoder_layers:
            x = layer(x, memory, mask)
        return x

    def forward(self, src_points: torch.Tensor,
                tgt_points: torch.Tensor | None = None):
        memory = self.encode(src_points)
        B = src_points.shape[0]
        if tgt_points is not None:
            sos = tgt_points.new_zeros((B, 1, self.outdim))
            tgt = torch.cat([sos, tgt_points], dim=1)
            emb = self.points_embedding(tgt) + self.pos_enc[:tgt.shape[1]]
            out = self.decode(emb, memory)
            return self.output_layer(out), torch.sigmoid(self.eos_layer(out))
        seq = src_points.new_zeros((B, self.max_seq_len + 1, self.outdim))
        points, eos = [], []
        for i in range(self.max_seq_len):
            out = self.decode(self.points_embedding(seq) + self.pos_enc,
                              memory)
            nxt = self.output_layer(out[:, i])
            points.append(nxt)
            eos.append(torch.sigmoid(self.eos_layer(out[:, i])))
            seq = torch.cat([seq[:, :i + 1], nxt[:, None], seq[:, i + 2:]],
                            dim=1)
        return torch.stack(points, dim=1), torch.stack(eos, dim=1)
