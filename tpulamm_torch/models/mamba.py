"""Mamba (selective state-space) forward (counterpart of
tpulamm.models.mamba): build_mamba (llama.cpp:7980-8308) and the custom
ops it relies on:

- ggml_ssm_conv: depthwise causal conv1d over [conv_state | x]
  (ggml.c ssm_conv), carrying the last d_conv-1 columns as state
- ggml_ssm_scan (ggml.c:ggml_compute_forward_ssm_scan_f32): the per-channel
  selective scan with softplus(dt) inside the op (dt <= 20),
  state = state * exp(dt*A) + B * (x*dt);  y = state . C
then y = (y + D*x) * silu(z), out = ssm_out @ y (build_mamba :8100-8124).

The recurrent state is a pair of preallocated f32 tensors on the engine's
device, one row a slot (`MambaState`). The forward reads a batch's rows and
writes them back in place (a view's copy_ for an int slot or the first B
rows, index_copy_ for a tensor of slot ids), and reset_slot zeroes rows in
place, so a captured decode step (runtime.decode_graph) makes no host copy
and the graph keeps reading the same storage.

The JAX package runs both recurrences under lax.scan, outside any Pallas
kernel. Here the conv is one unfold over [tail | x] and the scan a plain
loop over T: dA and dBx are made for the whole ubatch, as the JAX scan
makes them, and step t updates dBx[:, t] in place to the state after
token t (one launch a step); y is then one product with C. Padding rows
(position < 0) leave the state as it is: their dt is 0, so dA = 1 and
dBx = 0, and the conv tail moves past the valid tokens only. A row's valid
tokens must come first (the engines pad at the end, or run whole rows
idle), which is what the JAX scan's per-token select computes then.

ssm_in and ssm_out go through qmatmul (qmm at prefill, qmm_int8 at
decode, on CUDA); ssm_x, ssm_dt and a head whose widths do not tile stay
dense, as the loader stores them (models/loader.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.models.transformer import Params, _norm, _proj, embed
from tpulamm_torch.parallel.mesh import ShardedParams, run_forward
from tpulamm_torch.ops.layers import silu


@dataclass
class MambaState:
    """Recurrent state: conv tail + SSM state per (layer, slot), f32."""

    conv: torch.Tensor   # (L, n_slots, d_inner, d_conv-1)
    ssm: torch.Tensor    # (L, n_slots, d_inner, d_state)

    @staticmethod
    def create(cfg: ModelConfig, n_slots: int, device="cpu") -> "MambaState":
        return MambaState(
            conv=torch.zeros((cfg.n_layers, n_slots, cfg.ssm_d_inner,
                              cfg.ssm_d_conv - 1), dtype=torch.float32,
                             device=device),
            ssm=torch.zeros((cfg.n_layers, n_slots, cfg.ssm_d_inner,
                             cfg.ssm_d_state), dtype=torch.float32,
                            device=device))

    def reset_slot(self, slot: int) -> None:
        self.conv[:, slot].zero_()
        self.ssm[:, slot].zero_()

    def copy_slot(self, src: int, dst: int) -> None:
        self.conv[:, dst].copy_(self.conv[:, src])
        self.ssm[:, dst].copy_(self.ssm[:, src])

    def save_slot(self, slot: int) -> tuple[torch.Tensor, torch.Tensor]:
        """A copy of a slot's rows, for restore_slot."""
        return self.conv[:, slot].clone(), self.ssm[:, slot].clone()

    def restore_slot(self, slot: int, rows) -> None:
        """Put back the rows save_slot took (in place)."""
        self.conv[:, slot].copy_(rows[0])
        self.ssm[:, slot].copy_(rows[1])


def _rows(buf: torch.Tensor, slots, B: int) -> torch.Tensor:
    """One layer's state rows of the batch: a view for None (the first B
    slots) or an int slot, a gathered copy for a tensor of slot ids."""
    if slots is None:
        return buf[:B]
    if isinstance(slots, int):
        return buf[slots:slots + 1]
    return buf.index_select(0, slots.to(torch.long))


def _write_rows(buf: torch.Tensor, slots, new: torch.Tensor) -> None:
    """Write a batch's new state rows back into the layer's buffer in place."""
    if slots is None:
        buf[:new.shape[0]].copy_(new)
    elif isinstance(slots, int):
        buf[slots:slots + 1].copy_(new)
    else:
        buf.index_copy_(0, slots.to(torch.long), new)


def _conv1d(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
            n_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv (ggml_ssm_conv). x: (B, T, C) f32;
    conv_state: (B, C, d_conv-1); w: (C, d_conv); n_valid: (B,) the count
    of valid tokens of each row (they come first). Returns (y (B, T, C),
    the tail after the valid tokens)."""
    dconv = w.shape[-1]
    timeline = torch.cat([conv_state, x.transpose(1, 2)], dim=-1)
    windows = timeline.unfold(-1, dconv, 1)                 # (B, C, T, dconv)
    y = (windows * w[None, :, None, :]).sum(-1)             # (B, C, T)
    idx = (n_valid[:, None] + torch.arange(dconv - 1, device=x.device)
           )[:, None, :].expand(-1, timeline.shape[1], -1)
    return y.transpose(1, 2), torch.gather(timeline, 2, idx)


def _ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor,
              valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan (ggml_ssm_scan, softplus inside). x, dt: (B, T,
    d_inner); A: (d_inner, d_state); Bm, Cm: (B, T, d_state); state: (B,
    d_inner, d_state); valid: (B, T) 1.0 / 0.0."""
    dt_sp = torch.where(dt <= 20.0, torch.log1p(torch.exp(dt)), dt)
    dt_sp = dt_sp * valid[..., None]                  # padding: dt = 0
    dA = torch.exp(dt_sp[..., None] * A[None, None])  # (B, T, di, ds)
    # dBx[:, t] becomes the state after token t
    dBx = (dt_sp * x)[..., None] * Bm[:, :, None, :]  # (B, T, di, ds)
    prev = state
    for t in range(x.shape[1]):
        dBx[:, t].addcmul_(prev, dA[:, t])
        prev = dBx[:, t]
    y = torch.einsum("btds,bts->btd", dBx, Cm)
    return y, dBx[:, -1]


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, state: MambaState,
            slots: int | torch.Tensor | None, cells: torch.Tensor = None,
            kv_span: int | None = None, t_bucket: int | None = None,
            segs: torch.Tensor | None = None, last_row: bool = False
            ) -> tuple[torch.Tensor, MambaState]:
    """tokens / positions: (B, T); slots: (B,) slot ids, an int slot of a
    one-row batch, or None for the first B slots -> (logits (B, T, vocab)
    f32, the state updated in place). Signature-compatible with
    transformer.forward (cells, kv_span, t_bucket and segs are ignored: a
    recurrent state has no attention), so the engine and its step graphs
    drive either family. Without params["output"] the final-norm hidden
    states (B, T, dim) f32 take the logits' place; last_row: each row's
    last position only, (B, 1, ...). On a dp mesh (params
    a ShardedParams, state a MeshCache of per-group states; a recurrent
    model has no tp) each dp group's rows run over its own state."""
    if isinstance(params, ShardedParams):
        def group(g, cfg, tok, pos, sl, ce, segs=None, embeds=None, **kw):
            return forward(g.params[0], cfg, tok, pos, g.caches[0], sl)[0]
        return run_forward(group, params, tokens, positions, state, slots,
                           cells, last_row=last_row)
    del cells, kv_span, t_bucket, segs
    B, T = tokens.shape
    valid_b = positions >= 0
    valid = valid_b.to(torch.float32)
    n_valid = valid_b.sum(1)
    h = embed(params, cfg, tokens).to(torch.float32)
    dr, ds = cfg.ssm_dt_rank, cfg.ssm_d_state
    for il, layer in enumerate(params["layers"]):
        hn = _norm(h, layer, "attn_norm", cfg).to(torch.float32)
        xz = _proj(hn, layer["ssm_in"], cfg).to(torch.float32)
        x, z = xz.chunk(2, dim=-1)                         # (B, T, d_inner)

        x, conv_s = _conv1d(x, _rows(state.conv[il], slots, B),
                            layer["ssm_conv1d"], n_valid)
        _write_rows(state.conv[il], slots, conv_s)
        if layer.get("ssm_conv1d_b") is not None:
            x = x + layer["ssm_conv1d_b"]
        x = silu(x)

        x_db = _proj(x, layer["ssm_x"], cfg).to(torch.float32)
        dt = _proj(x_db[..., :dr], layer["ssm_dt"], cfg).to(torch.float32)
        if layer.get("ssm_dt_b") is not None:
            dt = dt + layer["ssm_dt_b"]
        y, ssm_s = _ssm_scan(x, dt, layer["ssm_a"], x_db[..., dr:dr + ds],
                             x_db[..., dr + ds:],
                             _rows(state.ssm[il], slots, B), valid)
        _write_rows(state.ssm[il], slots, ssm_s)
        y = (y + x * layer["ssm_d"]) * silu(z)
        h = h + _proj(y, layer["ssm_out"], cfg).to(torch.float32)

    h = _norm(h, params, "out_norm", cfg)
    if params.get("output") is None:
        # headless: final hidden states (llama_get_embeddings path)
        out = h
    else:
        out = _proj(h.to(cfg.cdtype), params["output"], cfg)
        if out.shape[-1] != cfg.vocab_size:
            out = out[..., : cfg.vocab_size]         # tile-padded head
    return (out[:, -1:] if last_row else out).to(torch.float32), state
