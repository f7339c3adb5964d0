"""Sparse Mixture-of-Experts decoder, Mixtral-style (port of
``polyaxon_tpu/models/moe.py``).

Attention, RoPE and the norms are the llama block's (``models/llama.py``:
the prompt pass and training reach the flash kernels through
``dot_product_attention``, paged decode the paged-decode kernel); the MLP
is replaced by ``moe_block``, top-k routing over ``n_experts`` SwiGLU
experts with a per-expert capacity. Tokens over a full expert's capacity
are dropped (the residual keeps them), the capacity-factor contract.

Two dispatch formulations, as in the JAX package:

- ``ragged`` (the default for training and a full prompt pass):
  (token, choice) pairs are placed by per-expert counts (cumsums of
  one-hot masks) and moved by gather and scatter; the expert FFN is one
  batched product ``[E, C, D] x [E, D, F]``. The JAX package runs it per
  ``ep`` shard with all-to-alls over the mesh; one device is its
  ``ep == 1`` case, and an ``ep`` axis is the model-parallel half of
  the parallel layer (ROADMAP.md, Queue 1 item 7b). The JAX scatters
  drop out-of-range writes (``mode="drop"``); here each dropped write
  goes to one spare row or slot that is sliced off afterwards.
- ``dense``: GShard one-hot dispatch and combine tensors ``[T, E, C]``
  and three products. Decode, the verify chunk and the suffix prefill
  always take it, with the capacity floored at the group size
  (``min_capacity``) so that serving never drops.

``router="expert_choice"`` lets experts pick their top-capacity tokens
(balanced by construction, no aux loss); it cannot be decoded.

The expert FFNs, dispatch and combine are plain PyTorch: the reference
computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from polyaxon_tpu_torch.models import llama
from polyaxon_tpu_torch.models.common import (
    ModelDef,
    Variables,
    _w,
    chunked_lm_loss,
    lm_logits,
    remat_body,
    rms_norm,
    sample_logits,
    scaled_init,
    shift_right,
    tree_from_numpy,
    truncated_normal_init,
)
# The continuous-batching hooks, the caches and the kernel-shape check are
# the llama decoder's: admission rules, cache layouts (MoE configs carry
# no sliding window) and paged inserts that are pure indexing.
from polyaxon_tpu_torch.models.llama import (  # noqa: F401  (re-exported)
    cb_admission,
    cb_init_cache,
    cb_validate,
    check_kernel_shapes,
    init_cache,
    insert_cache_row,
    paged_init_cache,
    paged_insert_prefill,
    paged_insert_suffix,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32_000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336  # per expert
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    loss_chunk: int = 256
    lm_logits_chunk: int = 4096
    # "top_k" (tokens choose experts) | "expert_choice".
    router: str = "top_k"
    # "ragged" | "dense" (see the module docstring).
    dispatch: str = "ragged"
    # Ragged-only: per-(source, destination) send-buffer headroom as a
    # multiple of the balanced share.
    send_capacity_margin: float = 2.0
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: str = "none"
    # "auto" = the flash kernels on CUDA tensors, einsum on the CPU (the
    # port's default, as for llama; the reference's is "xla").
    attention_impl: str = "auto"
    paged_attention_impl: str = "auto"

    # What the llama block's shared steps read; MoE configs carry none of
    # these knobs.
    rope_scaling = None
    sliding_window = None
    norm_offset = 0.0
    flash_block_q = None
    flash_block_k = None
    flash_bwd_impl = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS: dict[str, MoEConfig] = {
    "mixtral_8x7b": MoEConfig(),
    "moe_8x200m": MoEConfig(
        vocab_size=32_000, dim=1024, n_layers=12, n_heads=16, n_kv_heads=8,
        ffn_dim=2816, n_experts=8, max_seq_len=2048, rope_theta=10_000.0,
    ),
    "moe_tiny": MoEConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, n_experts=4, max_seq_len=128, rope_theta=10_000.0,
    ),
}

_GAINS = ("attn_norm", "moe_norm", "final_norm")


def init(cfg: MoEConfig, generator: torch.Generator, *, device,
         param_dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters from ``generator`` (the JAX ``init``'s shapes,
    scales and truncation; the draws differ). Each layer, and each
    expert of a layer, is drawn on its own, so the f32 draw never holds
    more than one ``[D, F]`` slab (mixtral_8x7b's stacked ``w_gate`` is
    30 GB in f32)."""
    L, D, F_, E = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_experts
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def stacked(shape, fan_in, experts: bool = False):
        full = (L, E, *shape) if experts else (L, *shape)
        out = torch.empty(full, dtype=param_dtype, device=device)
        for i in range(L):
            for e in range(E if experts else 1):
                dst = out[i, e] if experts else out[i]
                dst.copy_(scaled_init(shape, generator, device=device,
                                      dtype=param_dtype, fan_in=fan_in))
        return out

    ones = torch.ones((L, D), dtype=torch.float32, device=device)
    params = {
        "embed": truncated_normal_init((cfg.vocab_size, D), generator,
                                       device=device, dtype=param_dtype),
        "layers": {
            "attn_norm": ones,
            "wq": stacked((D, H * Hd), D),
            "wk": stacked((D, KV * Hd), D),
            "wv": stacked((D, KV * Hd), D),
            "wo": stacked((H * Hd, D), H * Hd),
            "moe_norm": ones.clone(),
            "router": stacked((D, E), D),
            "w_gate": stacked((D, F_), D, experts=True),
            "w_up": stacked((D, F_), D, experts=True),
            "w_down": stacked((F_, D), F_, experts=True),
        },
        "final_norm": torch.ones((D,), dtype=torch.float32, device=device),
        "lm_head": truncated_normal_init((D, cfg.vocab_size), generator,
                                         device=device, dtype=param_dtype),
    }
    return {"params": params, "state": {}}


def params_from_numpy(cfg: MoEConfig, tree: dict, *, device,
                      param_dtype: torch.dtype = torch.float32) -> dict:
    """JAX parameters as numpy arrays → port tensors (identity map;
    norm gains f32)."""
    del cfg
    return tree_from_numpy(tree, device=device, param_dtype=param_dtype,
                           f32_names=_GAINS)


def _router_aux_loss(cfg: MoEConfig, frac_tokens: torch.Tensor,
                     frac_probs: torch.Tensor) -> torch.Tensor:
    """Load-balancing aux loss (Switch eq. 4): E * sum_e(frac_tokens_e *
    frac_probs_e); 1.0 when perfectly uniform."""
    return cfg.n_experts * (frac_tokens * frac_probs).sum()


def _exclusive_count(onehot: torch.Tensor) -> torch.Tensor:
    """For each row of a one-hot [N, E] (int), how many earlier rows
    picked its column: the slot the row takes in that column's buffer
    (0 for an all-zero row)."""
    return ((onehot.cumsum(0) - onehot) * onehot).sum(-1)


def _top_k(probs: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The router's choice for probs [T, E]: (the top-k probabilities
    renormalized to sum to 1, their expert ids), both [T, k]. The one
    place a routing is decided, for both dispatches."""
    top_probs, top_idx = torch.topk(probs, k, dim=-1)
    return top_probs / top_probs.sum(-1, keepdim=True), top_idx


def _experts(cfg: MoEConfig, expert_in: torch.Tensor, w_gate, w_up,
             w_down) -> torch.Tensor:
    """The batched SwiGLU FFN: [E, C, D] → [E, C, D]."""
    dt = cfg.dtype
    gate = F.silu(torch.bmm(expert_in, _w(w_gate, dt)))
    up = torch.bmm(expert_in, _w(w_up, dt))
    return torch.bmm(gate * up, _w(w_down, dt))


def _moe_ragged_sharded(cfg: MoEConfig, x: torch.Tensor, router_w, w_gate,
                        w_up, w_down):
    """Ragged expert dispatch for x [T, D] (token-major pairs): the JAX
    function's ``ep == 1`` case, with the same capacities, slots and drop
    order. Returns (out [T, D], aux f32)."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    dt = cfg.dtype
    dev = x.device
    capacity = max(int(math.ceil(T * cfg.capacity_factor * K / E)), K)
    s_cap = max(int(math.ceil(T * K * cfg.capacity_factor
                              * cfg.send_capacity_margin)), K)
    s_cap = min(s_cap, T * K)

    logits = (x @ _w(router_w, dt)).to(torch.float32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = _top_k(probs, K)  # [T, K]

    # (token, choice) pairs, token-major; one destination (ep == 1).
    P_ = T * K
    eloc = top_idx.reshape(P_)
    w_pair = top_probs.reshape(P_)
    tok = torch.arange(P_, device=dev) // K
    pos_in_dest = torch.arange(P_, device=dev)
    keep = pos_in_dest < s_cap
    # Send buffers with one spare slot for the pairs past s_cap.
    slot = torch.where(keep, pos_in_dest, torch.full_like(pos_in_dest, s_cap))
    send_x = x.new_zeros((s_cap + 1, D)).index_put((slot,), x[tok])[:s_cap]
    send_eloc = torch.full((s_cap + 1,), -1, dtype=torch.long,
                           device=dev).index_put((slot,), eloc)[:s_cap]

    # Owner side: per-expert counts → slots → batched FFN.
    re = send_eloc
    e_oh = (re[:, None] == torch.arange(E, device=dev)).long()  # -1 → 0s
    pos_in_e = _exclusive_count(e_oh)
    keep_e = (re >= 0) & (pos_in_e < capacity)
    slot_e = torch.where(keep_e, pos_in_e, torch.full_like(pos_in_e,
                                                           capacity))
    eid = torch.where(re >= 0, re, torch.zeros_like(re))
    # One spare expert row and slot for the dropped rows.
    expert_in = send_x.new_zeros((E + 1, capacity + 1, D)).index_put(
        (torch.where(keep_e, eid, torch.full_like(eid, E)), slot_e),
        send_x)[:E, :capacity]
    expert_out = _experts(cfg, expert_in, w_gate, w_up, w_down)
    out_rows = torch.where(
        keep_e[:, None], expert_out[eid, slot_e.clamp(max=capacity - 1)],
        torch.zeros((), dtype=expert_out.dtype, device=dev))

    # Return trip and weighted combine.
    out_pair = torch.where(
        keep[:, None], out_rows[slot.clamp(max=s_cap - 1)],
        torch.zeros((), dtype=out_rows.dtype, device=dev))
    out = x.new_zeros((T, D)).index_add(
        0, tok, out_pair * w_pair[:, None].to(out_pair.dtype))

    frac_tokens = (top_idx[:, 0:1] == torch.arange(E, device=dev)).to(
        torch.float32).mean(0)
    aux = _router_aux_loss(cfg, frac_tokens, probs.mean(0))
    return out, aux


def moe_block(cfg: MoEConfig, x: torch.Tensor, router_w, w_gate, w_up,
              w_down, min_capacity: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (output [B, S, D], router aux loss f32 scalar).

    ``min_capacity`` floors the per-expert buffer; decode passes its
    group size so serving never drops tokens."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    capacity = max(int(math.ceil(T * cfg.capacity_factor * K / E)), K,
                   min_capacity)
    dt = cfg.dtype
    if cfg.dispatch not in ("dense", "ragged"):
        raise ValueError(f"unknown MoE dispatch `{cfg.dispatch}`")
    tokens = x.reshape(T, D)
    if (cfg.dispatch == "ragged" and cfg.router == "top_k"
            and min_capacity == 0):
        out, aux = _moe_ragged_sharded(cfg, tokens, router_w, w_gate, w_up,
                                       w_down)
        return out.reshape(B, S, D), aux

    logits = (tokens @ _w(router_w, dt)).to(torch.float32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)

    if cfg.router == "expert_choice":
        # Experts pick their top-capacity tokens; tokens outside every
        # expert's choice pass through the residual unchanged.
        g, idx = torch.topk(probs.T, min(capacity, T), dim=-1)  # [E, C]
        expert_out = _experts(cfg, tokens[idx], w_gate, w_up, w_down)
        weighted = (g[..., None].to(dt) * expert_out).reshape(-1, D)
        out = tokens.new_zeros((T, D)).index_add(0, idx.reshape(-1),
                                                 weighted)
        return out.reshape(B, S, D), torch.zeros((), dtype=torch.float32,
                                                 device=x.device)
    if cfg.router != "top_k":
        raise ValueError(f"unknown MoE router `{cfg.router}`")

    top_probs, top_idx = _top_k(probs, K)  # [T, K]

    # Per choice, the slot of each token in its expert's buffer: how many
    # earlier (choice-major) pairs picked that expert.
    onehot = (top_idx[..., None] == torch.arange(E, device=x.device)).to(
        torch.float32)  # [T, K, E]
    oh_km = onehot.transpose(0, 1)  # [K, T, E]
    flat = oh_km.reshape(K * T, E)
    pos_in_expert = ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(K, T)
    keep = pos_in_expert < capacity
    # A slot past capacity one-hots to zeros (jax.nn.one_hot's rule).
    slot_onehot = (pos_in_expert.to(torch.long)[..., None]
                   == torch.arange(capacity, device=x.device)).to(
                       torch.float32)  # [K, T, C]
    keep_f = keep.to(torch.float32)
    dispatch = torch.einsum("kte,ktc->tec", oh_km,
                            slot_onehot * keep_f[..., None])
    combine = torch.einsum("kte,ktc,kt->tec", oh_km, slot_onehot,
                           top_probs.T * keep_f)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), tokens)
    expert_out = _experts(cfg, expert_in, w_gate, w_up, w_down)
    out = torch.einsum("tec,ecd->td", combine.to(dt), expert_out)
    aux = _router_aux_loss(cfg, onehot[:, 0, :].mean(0), probs.mean(0))
    return out.reshape(B, S, D), aux


def _moe_residual(cfg: MoEConfig, x: torch.Tensor, layer: dict,
                  min_capacity: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, layer["moe_norm"], cfg.norm_eps)
    out, aux = moe_block(cfg, h, layer["router"], layer["w_gate"],
                         layer["w_up"], layer["w_down"],
                         min_capacity=min_capacity)
    return x + out, aux


def _layer(cfg: MoEConfig, x: torch.Tensor, layer: dict,
           positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q, k, v = llama._qkv(cfg, layer, x, positions)
    attn = llama._attention(cfg, q, k, v)
    x = x + attn.reshape(B, S, -1) @ _w(layer["wo"], cfg.dtype)
    return _moe_residual(cfg, x, layer)


def hidden_states(cfg: MoEConfig, params: dict, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B, S] → (final-norm hidden [B, S, D], mean router aux
    loss)."""
    B, S = tokens.shape
    if positions is None:
        positions = llama._positions(B, S, tokens.device)
    x = llama._embed(cfg, params, tokens, cfg.dtype)
    body = remat_body(functools.partial(_layer, cfg), cfg.remat)
    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in llama._layers(params):
        x, aux = body(x, layer, positions)
        aux_sum = aux_sum + aux
    return (rms_norm(x, params["final_norm"], cfg.norm_eps),
            aux_sum / cfg.n_layers)


def forward(cfg: MoEConfig, params: dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids → (f32 logits [B, S, vocab], mean router aux loss)."""
    x, aux = hidden_states(cfg, params, tokens, positions)
    return (x @ _w(params["lm_head"], cfg.dtype)).to(torch.float32), aux


def apply(cfg: MoEConfig, variables: Variables, batch: dict,
          train: bool = True, rng=None):
    """Next-token LM loss plus ``router_aux_coef`` × the router aux loss;
    the aux term is also returned as ``loss_unweighted`` so that gradient
    accumulation weights it per microbatch (``runtime/step.py``)."""
    tokens = batch["tokens"]
    if batch.get("segments") is not None:
        raise ValueError(
            "moe models do not support packed sequences (segments) yet; "
            "use an unpacked dataset or a llama-family model")
    params = variables["params"]
    x, aux = hidden_states(cfg, params, shift_right(tokens))
    head = _w(params["lm_head"], cfg.dtype)
    ce, acc = chunked_lm_loss(x, head, tokens, batch.get("mask"),
                              chunk=cfg.loss_chunk)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"loss": loss, "ce_loss": ce, "router_aux": aux,
                  "loss_unweighted": cfg.router_aux_coef * aux,
                  "accuracy": acc}, variables["state"]


def logical_axes(cfg: MoEConfig) -> Variables:
    del cfg
    return {
        "params": {
            "embed": ("vocab", "embed"),
            "layers": {
                "attn_norm": ("layers", "embed"),
                "wq": ("layers", "embed", "heads"),
                "wk": ("layers", "embed", "kv_heads"),
                "wv": ("layers", "embed", "kv_heads"),
                "wo": ("layers", "heads", "embed"),
                "moe_norm": ("layers", "embed"),
                "router": ("layers", "embed", "expert"),
                "w_gate": ("layers", "expert", "embed", "mlp"),
                "w_up": ("layers", "expert", "embed", "mlp"),
                "w_down": ("layers", "expert", "mlp", "embed"),
            },
            "final_norm": ("embed",),
            "lm_head": ("embed", "vocab"),
        },
        "state": {},
    }


def model_def(name: str, **overrides) -> ModelDef:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    return ModelDef(
        name=name,
        init=lambda generator, device: init(cfg, generator, device=device),
        apply=functools.partial(apply, cfg),
        unit="tokens",
        config=cfg,
        uniform_metrics=("router_aux",),
        logical_axes=functools.partial(logical_axes, cfg),
        layer_stacks=("layers",),
    )


# ---------------------------------------------------------------- decode
def _check_decodable(cfg: MoEConfig) -> None:
    """Expert-choice routing selects tokens across the dispatch group, so
    a decode group cannot reproduce training-time selection: refused."""
    if cfg.router != "top_k":
        raise ValueError(
            f"MoE decode/generation requires router='top_k'; "
            f"'{cfg.router}' routes by group-wide selection that decode "
            "groups cannot reproduce")


def _prompt_pass(cfg: MoEConfig, params: dict, prompt: torch.Tensor):
    """The causal prompt sweep: (final hidden x [B, P, D], k_all, v_all
    [L, B, P, KV, Hd]). Routing runs over the B·P prompt tokens with the
    training capacity, as the JAX function routes them."""
    B, P = prompt.shape
    positions = llama._positions(B, P, prompt.device)
    x = llama._embed(cfg, params, prompt, cfg.dtype)
    ks, vs = [], []
    for layer in llama._layers(params):
        q, k, v = llama._qkv(cfg, layer, x, positions)
        attn = llama._attention(cfg, q, k, v)
        x = x + attn.reshape(B, P, -1) @ _w(layer["wo"], cfg.dtype)
        x, _ = _moe_residual(cfg, x, layer)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def prefill(cfg: MoEConfig, params: dict, prompt: torch.Tensor,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """One batched causal pass over prompt [B, P], filling a dense cache:
    (last-position logits [B, V] f32, cache)."""
    _check_decodable(cfg)
    B, P = prompt.shape
    if P > max_len:
        raise ValueError(f"prompt length {P} exceeds cache length "
                         f"{max_len}")
    x, k_all, v_all = _prompt_pass(cfg, params, prompt)
    cache = init_cache(cfg, B, max_len, device=prompt.device)
    cache["k"][:, :, :P] = k_all
    cache["v"][:, :, :P] = v_all
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ lm_head(cfg, params)).to(torch.float32)
    return logits, cache


def lm_head(cfg: MoEConfig, params: dict) -> torch.Tensor:
    """The [D, V] head table, dequantized whole if it is int8 (for a
    prompt pass, not a decode step)."""
    return _w(params["lm_head"], cfg.dtype)


def decode_logits(cfg: MoEConfig, params: dict,
                  x: torch.Tensor) -> torch.Tensor:
    return lm_logits(x, params["lm_head"], cfg.dtype,
                     chunk=cfg.lm_logits_chunk)


def decode_step_ragged(cfg: MoEConfig, params: dict, cache: dict,
                       tokens: torch.Tensor,
                       pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One step with per-row positions (-1 = idle) over the dense cache,
    updated in place. The router sees the B current tokens as its group,
    with the capacity floored at B: decode never drops."""
    _check_decodable(cfg)
    C = cache["k"].shape[2]
    positions, slot, valid = llama.ragged_cache_coords(pos, C)
    x = llama._embed(cfg, params, tokens, cfg.dtype)[:, None, :]
    for i, layer in enumerate(llama._layers(params)):
        x, _, _ = llama.cached_attn_step(cfg, layer, x, cache["k"][i],
                                         cache["v"][i], positions, slot,
                                         valid)
        x, _ = _moe_residual(cfg, x, layer, min_capacity=x.shape[0])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return decode_logits(cfg, params, x[:, 0]), cache


def decode_step(cfg: MoEConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict]:
    """Every row at the scalar position ``pos``."""
    B = tokens.shape[0]
    return decode_step_ragged(
        cfg, params, cache, tokens,
        torch.full((B,), int(pos), dtype=torch.long, device=tokens.device))


def decode_chunk(cfg: MoEConfig, params: dict, cache: dict,
                 tokens: torch.Tensor,
                 pos0: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The speculative verify chunk (and chunked prefill): llama's
    ``chunk_attn_step`` with the expert FFN in the MLP slot; routing sees
    the B·c chunk tokens with no-drop capacity."""
    _check_decodable(cfg)
    B, c = tokens.shape
    C = cache["k"].shape[2]
    dev = tokens.device
    positions = pos0.to(dev).long()[:, None] + torch.arange(c, device=dev)
    valid = (torch.arange(C, device=dev)[None, None, :]
             <= positions[:, :, None])[:, None]
    x = llama._embed(cfg, params, tokens, cfg.dtype)
    for i, layer in enumerate(llama._layers(params)):
        x, _, _ = llama.chunk_attn_step(cfg, layer, x, cache["k"][i],
                                        cache["v"][i], positions, valid)
        x, _ = _moe_residual(cfg, x, layer, min_capacity=B * c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return decode_logits(cfg, params, x), cache


def cb_prefill(cfg: MoEConfig, params: dict, prompt: torch.Tensor,
               max_len: int) -> dict:
    return prefill(cfg, params, prompt, max_len)[1]


def generate(cfg: MoEConfig, params: dict, prompt: torch.Tensor, *,
             max_new_tokens: int, temperature: float = 0.0,
             top_p: float = 1.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature 0) or sampled continuation of prompt [B, P]:
    [B, max_new], one prefill and a loop of decode steps."""
    B, P = prompt.shape
    sampling = temperature > 0
    if sampling and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    logits, cache = prefill(cfg, params, prompt, P + max_new_tokens)
    out = []
    for t in range(max_new_tokens):
        token = (sample_logits(logits, generator, temperature, top_p, top_k)
                 if sampling else logits.argmax(dim=-1))
        token = token.to(torch.long)
        out.append(token)
        if t + 1 < max_new_tokens:
            logits, cache = decode_step(cfg, params, cache, token, P + t)
    return torch.stack(out, dim=1)


# ------------------------------------------------------- paged KV decode
def decode_step_paged(cfg: MoEConfig, params: dict, cache: dict,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      tables: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step over the paged pool (llama's block-table
    semantics and the paged-decode kernel, the expert FFN in the MLP
    slot); the cache is updated in place."""
    _check_decodable(cfg)
    page = cache["k"].shape[2]
    positions, write_page, write_off, valid = llama.paged_coords(
        pos, tables, page)
    kernel_args = (llama.paged_kernel_args(positions, tables, valid)
                   if cfg.paged_attention_impl == "auto" else None)
    x = llama._embed(cfg, params, tokens, cfg.dtype)[:, None, :]
    for i, layer in enumerate(llama._layers(params)):
        x, _, _ = llama.paged_attn_step(
            cfg, layer, x, cache["k"][i], cache["v"][i], positions,
            write_page, write_off, tables, valid, kernel_args)
        x, _ = _moe_residual(cfg, x, layer, min_capacity=x.shape[0])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return decode_logits(cfg, params, x[:, 0]), cache


def paged_prefill_kv(cfg: MoEConfig, params: dict, prompt: torch.Tensor):
    """Raw per-position KV of a single-row prompt pass: [L, P, KV, Hd]."""
    _check_decodable(cfg)
    _, k_all, v_all = _prompt_pass(cfg, params, prompt)
    return k_all[:, 0], v_all[:, 0]


def paged_prefill_suffix_kv(cfg: MoEConfig, params: dict,
                            suffix: torch.Tensor, k_prefix: torch.Tensor,
                            v_prefix: torch.Tensor, m: int):
    """Suffix-only prefill after a radix prefix hit (llama's
    ``suffix_attn_step``, the expert FFN in the MLP slot). Routing sees
    the suffix tokens with no-drop capacity, where a full prefill routes
    the whole prompt with the training capacity: the JAX package's two
    paths compute different functions when that capacity drops tokens,
    and the port keeps each one's (ROADMAP.md, Queue 3)."""
    _check_decodable(cfg)
    B, S = suffix.shape
    m_pad = k_prefix.shape[1]
    positions = llama._positions(B, S, suffix.device, start=int(m))
    valid = llama._suffix_mask(S, m_pad, int(m), device=suffix.device)
    x = llama._embed(cfg, params, suffix, cfg.dtype)
    ks, vs = [], []
    for i, layer in enumerate(llama._layers(params)):
        x, k, v = llama.suffix_attn_step(cfg, layer, x, k_prefix[i][None],
                                         v_prefix[i][None], positions, valid)
        x, _ = _moe_residual(cfg, x, layer, min_capacity=B * S)
        ks.append(k[0])
        vs.append(v[0])
    return torch.stack(ks), torch.stack(vs)
