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
  (token, choice) pairs are placed by per-destination and per-expert
  counts (cumsums of one-hot masks) and moved by gather and scatter;
  the expert FFN is one batched product ``[E, C, D] x [E, D, F]``. Under
  a mesh with ``ep`` above 1 each ep rank holds ``E/ep`` experts and its
  token shard: the pairs go to their experts' owners in send buffers
  ``[ep, s_cap, D]`` through an ``all_to_all`` and come back through
  another (``ops/ulysses.py``'s ``all_to_all``, whose backward is the
  same exchange), with the JAX function's send cap and owner-side
  capacity over the global batch; one device is its ``ep == 1`` case.
  The sender decides each pair's place at its owner and sends it with
  the pair. The JAX scatters drop out-of-range writes
  (``mode="drop"``); here each dropped write goes to one spare row or
  slot that is sliced off afterwards. The router aux's
  fractions are means over every token of the global batch, as GSPMD
  computes them: averaged over the batch axes of the mesh.
- ``dense``: GShard one-hot dispatch and combine tensors ``[T, E, C]``
  and three products. Decode, the verify chunk and the suffix prefill
  always take it, with the capacity floored at the group size
  (``min_capacity``) so that serving never drops. Under a mesh whose
  batch axes hold different rows, its capacity and slots count the
  global batch, as GSPMD's do: the per-choice, per-expert counts of
  every row block (``_Blocks``) place this rank's pairs after theirs. A
  served batch is the same on every rank (``parallel/mesh.py
  replicated_rows``): one block. Over an ep axis each rank runs its
  ``E/ep`` experts on the tokens of every row block, and the ep group
  sums their parts (``moe_block``); a served batch's prompt pass takes
  the ragged dispatch as the JAX server computes it, the ``ep == 1``
  function, each rank its experts' pairs (``_moe_ragged_served``).

``router="expert_choice"`` lets experts pick their top-capacity tokens
of the global batch (balanced by construction, no aux loss); it cannot
be decoded.

Under ``tp`` the attention is the llama block's and each expert's
``mlp`` is column-parallel ``w_gate``/``w_up`` and row-parallel
``w_down``, its partial outputs summed (*reduce*) before the combine,
so the router and the combine compute on whole values.

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
from polyaxon_tpu_torch.parallel.mesh import (block_mean, current_mesh,
                                              row_block, row_block_axes)
from polyaxon_tpu_torch.parallel.sharding import WHOLE, ShardTaker
from polyaxon_tpu_torch.parallel.tensor import copy_to_tp, reduce_from_tp
from polyaxon_tpu_torch.models.common import (
    ModelDef,
    Variables,
    _w,
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
         param_dtype: torch.dtype = torch.float32,
         take: ShardTaker = WHOLE) -> dict:
    """Random parameters from ``generator`` (the JAX ``init``'s shapes,
    scales and truncation; the draws differ). Each layer, and each
    expert of a layer, is drawn on its own, so the f32 draw never holds
    more than one ``[D, F]`` slab (mixtral_8x7b's stacked ``w_gate`` is
    30 GB in f32); with a ``take`` over a mesh each rank keeps its piece
    of every slab (``models/llama.py init``)."""
    L, D, F_, E = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_experts
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def stacked(name, shape, fan_in, experts: bool = False):
        leaf = take.leaf(("layers", name),
                         (L, E, *shape) if experts else (L, *shape))
        out = torch.empty(leaf.shape, dtype=param_dtype, device=device)
        for i in range(L):
            for e in range(E if experts else 1):
                got = leaf.take(scaled_init(shape, generator, device=device,
                                            dtype=param_dtype,
                                            fan_in=fan_in),
                                *((i, e) if experts else (i,)))
                if got is not None:
                    out[got[0]] = got[1]
        return out

    def ones(path, shape):
        return take.whole(path, torch.ones(shape, dtype=torch.float32,
                                           device=device))

    def table(path, shape):
        return take.whole(path, truncated_normal_init(
            shape, generator, device=device, dtype=param_dtype))

    params = {
        "embed": table(("embed",), (cfg.vocab_size, D)),
        "layers": {
            "attn_norm": ones(("layers", "attn_norm"), (L, D)),
            "wq": stacked("wq", (D, H * Hd), D),
            "wk": stacked("wk", (D, KV * Hd), D),
            "wv": stacked("wv", (D, KV * Hd), D),
            "wo": stacked("wo", (H * Hd, D), H * Hd),
            "moe_norm": ones(("layers", "moe_norm"), (L, D)),
            "router": stacked("router", (D, E), D),
            "w_gate": stacked("w_gate", (D, F_), D, experts=True),
            "w_up": stacked("w_up", (D, F_), D, experts=True),
            "w_down": stacked("w_down", (F_, D), F_, experts=True),
        },
        "final_norm": ones(("final_norm",), (D,)),
        "lm_head": table(("lm_head",), (D, cfg.vocab_size)),
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
    (0 for an all-zero row). The scan runs along the contiguous last
    dimension of the transpose: on CUDA a scan down the N rows of a
    narrow [N, E] runs one thread per column, serially."""
    running = onehot.t().contiguous().cumsum(-1).t()
    return ((running - onehot) * onehot).sum(-1)


def _top_k(probs: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The router's choice for probs [T, E]: (the top-k probabilities
    renormalized to sum to 1, their expert ids), both [T, k]. The one
    place a routing is decided, for both dispatches."""
    top_probs, top_idx = torch.topk(probs, k, dim=-1)
    return top_probs / top_probs.sum(-1, keepdim=True), top_idx


def _experts(cfg: MoEConfig, expert_in: torch.Tensor, w_gate, w_up,
             w_down) -> torch.Tensor:
    """The batched SwiGLU FFN: [E, C, D] → [E, C, D] (under tp, this
    rank's ``mlp`` slice, the partials summed)."""
    dt = cfg.dtype
    expert_in = copy_to_tp(expert_in)
    gate = F.silu(torch.bmm(expert_in, _w(w_gate, dt)))
    up = torch.bmm(expert_in, _w(w_up, dt))
    return reduce_from_tp(torch.bmm(gate * up, _w(w_down, dt)))


def _ep_axis() -> tuple[int, object]:
    """(size, group) of the current mesh's ep axis; (1, None) without."""
    mesh = current_mesh()
    n = mesh.shape.get("ep", 1) if mesh is not None else 1
    return (n, mesh.group("ep")) if n > 1 else (1, None)


@dataclasses.dataclass
class _Dispatch:
    """One rank's side of the ragged dispatch: where its (token, choice)
    pairs go, which of them the JAX function keeps, its send buffers,
    and what the combine needs to bring the pairs back."""

    tok: torch.Tensor        # [P]: the pair's token
    dest: torch.Tensor       # [P]: its destination rank (expert owner)
    expert: torch.Tensor     # [P]: its expert
    pos: torch.Tensor        # [P]: its place among this rank's pairs to dest
    w_pair: torch.Tensor     # [P]: its routing weight
    dest_counts: torch.Tensor  # [ep]: this rank's pairs per destination
    frac_tokens: torch.Tensor  # [E]: this shard's top-1 fractions
    frac_probs: torch.Tensor   # [E]: this shard's mean probabilities
    keep: Optional[torch.Tensor] = None    # [P]: kept (send, then owner)
    sent: Optional[torch.Tensor] = None    # [P]: kept at the send cap
    sent_oh: Optional[torch.Tensor] = None    # [P, E]: sent, by expert
    send_x: Optional[torch.Tensor] = None     # [ep, s, D]
    send_code: Optional[torch.Tensor] = None  # [ep, s]: eloc·C + slot


def _capacities(cfg: MoEConfig, T_chunk: int, ep: int) -> tuple[int, int]:
    """(owner-side per-expert capacity, per-destination send cap) of the
    JAX function for ep chunks of ``T_chunk`` tokens: the dense path's
    capacity over all ``T_chunk·ep`` tokens, and the balanced
    per-destination share times a skew margin, never more than sending
    everything."""
    E, K = cfg.n_experts, cfg.experts_per_token
    capacity = max(int(math.ceil(T_chunk * ep * cfg.capacity_factor * K
                                 / E)), K)
    s_cap = max(int(math.ceil(T_chunk * K * cfg.capacity_factor
                              * cfg.send_capacity_margin / ep)), K)
    return capacity, min(s_cap, T_chunk * K)


def _route(cfg: MoEConfig, x: torch.Tensor, router: torch.Tensor,
           ep: int) -> _Dispatch:
    """Route this rank's tokens x [T_loc, D] through the whole router
    [D, E]: its (token, choice) pairs, token-major, each with its
    destination rank (``E/ep`` experts each) and its place among this
    rank's pairs to that rank."""
    T_loc = x.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_token
    dev = x.device
    logits = (x @ router).to(torch.float32)  # [T_loc, E]
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = _top_k(probs, K)  # [T_loc, K]
    expert = top_idx.reshape(-1)
    dest = expert // (E // ep)
    pairs = torch.arange(T_loc * K, device=dev)
    if ep == 1:  # one destination: a pair's place is its index
        pos, dest_counts = pairs, torch.full((1,), T_loc * K, device=dev)
    else:
        dest_oh = (dest[:, None] == torch.arange(ep, device=dev)).long()
        pos, dest_counts = _exclusive_count(dest_oh), dest_oh.sum(0)
    frac_tokens = (top_idx[:, 0:1] == torch.arange(E, device=dev)).to(
        torch.float32).mean(0)
    return _Dispatch(pairs // K, dest, expert, pos, top_probs.reshape(-1),
                     dest_counts, frac_tokens, probs.mean(0))


def _keep_sent(cfg: MoEConfig, d: _Dispatch,
               send_before: Optional[torch.Tensor], s_cap: int
               ) -> torch.Tensor:
    """The pairs that fit the send cap, after ``send_before`` [ep] pairs
    of the same ep chunk ahead of this rank (None: none); returns how
    many of them go to each expert [E]."""
    ahead = d.pos if send_before is None else d.pos + send_before[d.dest]
    d.sent = ahead < s_cap
    d.sent_oh = ((d.expert[:, None] == torch.arange(
        cfg.n_experts, device=d.pos.device)) & d.sent[:, None]).long()
    return d.sent_oh.sum(0)


def _place(cfg: MoEConfig, d: _Dispatch, x: torch.Tensor,
           owner_before: Optional[torch.Tensor], capacity: int, s_cap: int,
           ep: int) -> None:
    """Keep the sent pairs that fit their expert's capacity after
    ``owner_before`` [E] sent pairs of the blocks ahead of this rank
    (None: none; the owners' order: their slot there), and place the kept ones in
    send buffers by destination [ep, s, D] at their place among this
    rank's pairs to it (``s``, the same on every rank: the send cap, or
    this rank's pair count where that is smaller), each with its local
    expert and slot at the owner, ``eloc·capacity + slot``."""
    E_loc = cfg.n_experts // ep
    slot_e = _exclusive_count(d.sent_oh)
    if owner_before is not None:
        slot_e = slot_e + owner_before[d.expert]
    d.keep = d.sent & (slot_e < capacity)
    s = min(s_cap, d.pos.numel())
    # Every sent pair takes its slot (a pair its owner has no room for
    # goes with code -1): one spare slot takes only the pairs past the
    # send cap, as every write to it contends for the same row.
    slot = torch.where(d.sent, d.pos, torch.full_like(d.pos, s))
    code = torch.where(d.keep, (d.expert % E_loc) * capacity + slot_e,
                       torch.full_like(slot_e, -1))
    d.send_x = x.new_zeros((ep, s + 1, x.shape[1])).index_put(
        (d.dest, slot), x[d.tok])[:, :s]
    d.send_code = torch.full((ep, s + 1), -1, dtype=torch.long,
                             device=x.device).index_put(
        (d.dest, slot), code)[:, :s]


def _owner(cfg: MoEConfig, recv_x: torch.Tensor, recv_code: torch.Tensor,
           capacity: int, w_gate, w_up, w_down) -> torch.Tensor:
    """The owner side: the received pairs [ep, s, D] into their experts'
    slots (``recv_code``: ``eloc·capacity + slot``, -1 empty), the
    batched FFN of this rank's experts, the rows back in their received
    places."""
    ep, s, D = recv_x.shape
    E_loc = w_gate.shape[0]
    rx = recv_x.reshape(ep * s, D)
    code = recv_code.reshape(ep * s)
    kept = code >= 0
    # An empty row goes to a spare expert, and reads back a place of its
    # own (masked): rows sharing one place would write it, and sum into
    # it in the backward, one after another.
    spread = torch.arange(ep * s, device=rx.device) % (E_loc * capacity)
    flat = torch.where(kept, code, spread)
    expert_in = rx.new_zeros((E_loc + 1, capacity, D)).index_put(
        (torch.where(kept, code // capacity, torch.full_like(code, E_loc)),
         flat % capacity), rx)[:E_loc]
    expert_out = _experts(cfg, expert_in, w_gate, w_up, w_down)
    out_rows = torch.where(
        kept[:, None], expert_out.reshape(E_loc * capacity, D)[flat],
        torch.zeros((), dtype=expert_out.dtype, device=rx.device))
    return out_rows.reshape(ep, s, D)


def _combine(d: _Dispatch, back: torch.Tensor, T_loc: int) -> torch.Tensor:
    """The returned rows [ep, s, D], weighted into their tokens."""
    s = back.shape[1]
    out_pair = torch.where(
        d.keep[:, None], back[d.dest, d.pos.clamp(max=s - 1)],
        torch.zeros((), dtype=back.dtype, device=back.device))
    return back.new_zeros((T_loc, back.shape[-1])).index_add(
        0, d.tok, out_pair * d.w_pair[:, None].to(out_pair.dtype))


class _Blocks:
    """This rank's row block among the global batch's: the blocks are
    the ranks of the batch axes (dp, fsdp, ep), in that order, as the
    batch is laid out. The JAX function cuts the global tokens into ep
    contiguous chunks of ``n/ep`` blocks each (its ``shard_map`` over
    ep leaves dp automatic), so a chunk's pairs take their send slots
    block after block, and an owner takes its pairs chunk after chunk:
    in block order."""

    def __init__(self, mesh, ep: int):
        self.mesh = mesh
        self.axes = row_block_axes(mesh)
        self.n, self.index = row_block(mesh)
        self.chunk_first = self.index - self.index % (self.n // ep)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` [k] of every block, [n, k] in block order."""
        import torch.distributed as dist

        out = t[None]
        for name in reversed(self.axes):
            parts = [torch.empty_like(out)
                     for _ in range(self.mesh.shape[name])]
            dist.all_gather(parts, out.contiguous(),
                            group=self.mesh.group(name))
            out = torch.cat(parts)
        return out


def _moe_ragged_served(cfg: MoEConfig, x: torch.Tensor, router_w, w_gate,
                       w_up, w_down):
    """The ragged dispatch of a served batch over ep, the same tokens
    x [T, D] on every rank: the JAX server binds no ep axis around its
    calls, so it runs the ``ep == 1`` function over the whole batch.
    Each rank routes every pair as that function does and runs the pairs
    of its own ``E/ep`` experts; the ep group sums the parts."""
    from polyaxon_tpu_torch.parallel.fsdp import all_gather
    from polyaxon_tpu_torch.parallel.mesh import axis_rank
    from polyaxon_tpu_torch.parallel.tensor import _Reduce

    ep, group = _ep_axis()
    T = x.shape[0]
    capacity, s_cap = _capacities(cfg, T, 1)
    router = all_gather(_w(router_w, cfg.dtype), -1, group)
    d = _route(cfg, x, router, 1)
    _keep_sent(cfg, d, None, s_cap)
    _place(cfg, d, x, None, capacity, s_cap, 1)
    E_loc = cfg.n_experts // ep
    first = axis_rank(current_mesh(), "ep") * E_loc * capacity
    code = d.send_code
    mine = (code >= first) & (code < first + E_loc * capacity)
    back = _owner(cfg, d.send_x, torch.where(mine, code - first, -1),
                  capacity, w_gate, w_up, w_down)
    out = _Reduce.apply(_combine(d, back, T), group)
    return out, _router_aux_loss(cfg, d.frac_tokens, d.frac_probs)


def _moe_ragged_sharded(cfg: MoEConfig, x: torch.Tensor, router_w, w_gate,
                        w_up, w_down):
    """Ragged expert dispatch for this rank's token shard x [T_loc, D]
    over the current mesh's ep axis (one shard without one), computing
    the JAX function over the global batch: its capacities, slots and
    drops, which span every batch block of an ep chunk (``_Blocks``),
    from the per-destination and per-expert counts of every block; the
    expert weights are this rank's ``E/ep`` experts and the router its
    ``E/ep`` columns, gathered whole. Returns (out [T_loc, D], aux
    f32)."""
    from polyaxon_tpu_torch.ops.ulysses import _all_to_all, all_to_all
    from polyaxon_tpu_torch.parallel.fsdp import all_gather

    ep, group = _ep_axis()
    mesh = current_mesh()
    if ep > 1 and "ep" not in row_block_axes(mesh):
        return _moe_ragged_served(cfg, x, router_w, w_gate, w_up, w_down)
    T_loc = x.shape[0]
    blocks = _Blocks(mesh, ep)
    capacity, s_cap = _capacities(cfg, T_loc * blocks.n // ep, ep)
    router = _w(router_w, cfg.dtype)
    if ep > 1:
        router = all_gather(router, -1, group)
    d = _route(cfg, x, router, ep)
    first, me = blocks.chunk_first, blocks.index
    ahead = blocks.n > 1  # else no pairs come before this rank's
    counts = blocks.gather(d.dest_counts) if ahead else None
    kept = _keep_sent(cfg, d, counts[first:me].sum(0) if ahead else None,
                      s_cap)
    _place(cfg, d, x, blocks.gather(kept)[:me].sum(0) if ahead else None,
           capacity, s_cap, ep)
    recv_x, recv_code = d.send_x, d.send_code
    if ep > 1:
        recv_x = all_to_all(recv_x, group)
        recv_code = _all_to_all(recv_code, group)
    back = _owner(cfg, recv_x, recv_code, capacity, w_gate, w_up, w_down)
    if ep > 1:
        back = all_to_all(back, group)
    aux = _router_aux_loss(cfg, block_mean(d.frac_tokens),
                           block_mean(d.frac_probs))
    return _combine(d, back, T_loc), aux


def replay_ep(cfg: MoEConfig, x: torch.Tensor, router_w, w_gate, w_up,
              w_down, ep: int, drops: Optional[dict] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's ragged dispatch at dp1 x ``ep`` in one process, on
    the whole token set x [T, D] (rank i holding rows ``i·T/ep …``) and
    the whole expert weights [E, ...] (rank i owning experts
    ``i·E/ep …``): each rank's pairs routed and kept by ``_route``,
    ``_keep_sent`` and ``_place`` from the counts of the ranks ahead of
    it, the all-to-all done as the transpose it performs ([source]
    [destination] → [destination][source]), each owner running
    ``_owner`` on its experts, and the rows back by the inverse
    transpose into ``_combine``. The aux uses the global means, as the
    ranks' batch mean does. Equals the ``ep == 1`` dispatch wherever no
    capacity binds. ``drops`` receives the pairs dropped at the send
    caps and at the owners."""
    T = x.shape[0]
    T_loc, E_loc = T // ep, cfg.n_experts // ep
    capacity, s_cap = _capacities(cfg, T_loc, ep)
    router = _w(router_w, cfg.dtype)
    xs = x.split(T_loc)
    ds = [_route(cfg, xi, router, ep) for xi in xs]
    # One block per chunk at dp1: no sender ahead within a chunk.
    kept = torch.stack([_keep_sent(cfg, d, None, s_cap) for d in ds])
    for i, (d, xi) in enumerate(zip(ds, xs)):
        _place(cfg, d, xi, kept[:i].sum(0), capacity, s_cap, ep)
    sent_x = torch.stack([d.send_x for d in ds])        # [src, dst, ...]
    sent_c = torch.stack([d.send_code for d in ds])
    backs = torch.stack([
        _owner(cfg, sent_x[:, j], sent_c[:, j], capacity,
               *(w[j * E_loc:(j + 1) * E_loc]
                 for w in (w_gate, w_up, w_down)))
        for j in range(ep)])                             # [dst, src, ...]
    if drops is not None:
        drops["send"] = int(sum(int((~d.sent).sum()) for d in ds))
        drops["owner"] = int(sum(int((d.sent & ~d.keep).sum()) for d in ds))
    out = torch.cat([_combine(d, backs[:, i], T_loc)
                     for i, d in enumerate(ds)])
    aux = _router_aux_loss(cfg, torch.stack([d.frac_tokens for d in ds]
                                            ).mean(0),
                           torch.stack([d.frac_probs for d in ds]).mean(0))
    return out, aux


class _SumOwnRows(torch.autograd.Function):
    """Partials [n·T, D] of the ``n`` row blocks of an ep group (in
    order) summed over the group, this rank's block ``index`` kept; the
    backward hands each rank's partial the gradient of every block of
    the group (an all-gather over ep)."""

    @staticmethod
    def forward(ctx, partial, group, n, index):
        import torch.distributed as dist

        ctx.group, ctx.n = group, n
        total = partial.contiguous().clone()
        dist.all_reduce(total, group=group)
        return total.chunk(n)[index].clone()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        parts = [torch.empty_like(g, memory_format=torch.contiguous_format)
                 for _ in range(ctx.n)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts), None, None, None


def _rows_of_blocks(x: torch.Tensor, mesh) -> torch.Tensor:
    """The tokens of every row block of the global batch, in block order
    (``_Blocks``), gathered differentiably: the backward sums each
    rank's gradient of every block into the block's own rank."""
    from polyaxon_tpu_torch.parallel.fsdp import all_gather

    for name in reversed(row_block_axes(mesh)):
        x = all_gather(x, 0, mesh.group(name))
    return x


def _gshard(cfg: MoEConfig, tokens: torch.Tensor, probs: torch.Tensor,
            experts: tuple, lo: int, capacity: int,
            blocks: "_Blocks") -> tuple[torch.Tensor, torch.Tensor]:
    """The GShard top-k dispatch of tokens [T, D] routed by probs [T, E]
    through the experts ``lo …`` whose weights ``experts`` holds: (their
    part of the output [T, D], the top-1 fractions [E]). Each (choice,
    token) pair's slot in its expert's buffer is how many pairs picked
    that expert before it, choice-major over the global batch, as GSPMD
    counts them: every block's pairs of the earlier choices, then the
    pairs of its choice in the row blocks ahead of this one (``blocks``),
    then this block's own earlier tokens'."""
    E, K = cfg.n_experts, cfg.experts_per_token
    dt = cfg.dtype
    E_loc = experts[0].shape[0]
    top_probs, top_idx = _top_k(probs, K)  # [T, K]
    onehot = (top_idx[..., None] == torch.arange(E, device=tokens.device)
              ).to(torch.float32)  # [T, K, E]
    oh_km = onehot.transpose(0, 1)  # [K, T, E]
    counts = oh_km.sum(1)  # [K, E]
    ahead = torch.zeros_like(counts)
    if blocks.n > 1:
        every = blocks.gather(counts.reshape(-1)).reshape(blocks.n, K, E)
        counts, ahead = every.sum(0), every[:blocks.index].sum(0)
    # The scan runs along the contiguous last dimension (_exclusive_count).
    within = oh_km.transpose(1, 2).contiguous().cumsum(-1).transpose(1, 2)
    pos_in_expert = ((within - oh_km + (counts.cumsum(0) - counts
                                        + ahead)[:, None])
                     * oh_km).sum(-1)  # [K, T]
    keep = pos_in_expert < capacity
    # A slot past capacity one-hots to zeros (jax.nn.one_hot's rule).
    slot_onehot = (pos_in_expert.to(torch.long)[..., None]
                   == torch.arange(capacity, device=tokens.device)).to(
                       torch.float32)  # [K, T, C]
    keep_f = keep.to(torch.float32)
    mine = oh_km[..., lo:lo + E_loc]
    dispatch = torch.einsum("kte,ktc->tec", mine,
                            slot_onehot * keep_f[..., None])
    combine = torch.einsum("kte,ktc,kt->tec", mine, slot_onehot,
                           top_probs.T * keep_f)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), tokens)
    expert_out = _experts(cfg, expert_in, *experts)
    out = torch.einsum("tec,ecd->td", combine.to(dt), expert_out)
    return out, onehot[:, 0, :].mean(0)


def _expert_choice(cfg: MoEConfig, tokens: torch.Tensor,
                   probs: torch.Tensor, experts: tuple, lo: int,
                   capacity: int) -> torch.Tensor:
    """Experts ``lo …`` pick their top-capacity tokens of tokens [T, D]
    by probs [T, E]: their part of the output [T, D]; tokens outside
    every expert's choice pass through the residual unchanged."""
    T, D = tokens.shape
    E_loc = experts[0].shape[0]
    g, idx = torch.topk(probs.T[lo:lo + E_loc], min(capacity, T),
                        dim=-1)  # [E_loc, C]
    expert_out = _experts(cfg, tokens[idx], *experts)
    weighted = (g[..., None].to(cfg.dtype) * expert_out).reshape(-1, D)
    return tokens.new_zeros((T, D)).index_add(0, idx.reshape(-1), weighted)


def moe_block(cfg: MoEConfig, x: torch.Tensor, router_w, w_gate, w_up,
              w_down, min_capacity: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (output [B, S, D], router aux loss f32 scalar).

    ``min_capacity`` floors the per-expert buffer; decode passes its
    group size so serving never drops tokens.

    Over an ep axis the dense dispatch and the expert-choice router run
    on the tokens of every row block (``_rows_of_blocks``; a served
    batch is one block, the same on every rank), so that the slots and
    the experts' choices are the global batch's, as GSPMD computes them:
    each rank runs its ``E/ep`` experts, and the ep group sums their
    parts, each rank keeping its own rows (``_SumOwnRows``)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    if cfg.dispatch not in ("dense", "ragged"):
        raise ValueError(f"unknown MoE dispatch `{cfg.dispatch}`")
    if cfg.router not in ("top_k", "expert_choice"):
        raise ValueError(f"unknown MoE router `{cfg.router}`")
    tokens = x.reshape(B * S, D)
    if (cfg.dispatch == "ragged" and cfg.router == "top_k"
            and min_capacity == 0):
        out, aux = _moe_ragged_sharded(cfg, tokens, router_w, w_gate, w_up,
                                       w_down)
        return out.reshape(B, S, D), aux

    mesh = current_mesh()
    ep, group = _ep_axis()
    router = _w(router_w, cfg.dtype)
    experts = (w_gate, w_up, w_down)
    lo, T_own = 0, tokens.shape[0]
    blocks = _Blocks(mesh, 1)
    # The expert-choice router picks among the global batch's tokens, and
    # over ep each owner's experts read every row block's.
    gather = blocks.n > 1 and (ep > 1 or cfg.router == "expert_choice")
    if ep > 1:
        from polyaxon_tpu_torch.parallel.fsdp import all_gather
        from polyaxon_tpu_torch.parallel.mesh import axis_rank

        router = all_gather(router, -1, group)
        lo = axis_rank(mesh, "ep") * (E // ep)
    if gather:
        tokens = _rows_of_blocks(tokens, mesh)
        index = blocks.index
        blocks = _Blocks(None, 1)  # every block is here, in order
    T = tokens.shape[0]
    # The capacity counts the global tokens.
    capacity = max(int(math.ceil(T * blocks.n * cfg.capacity_factor * K
                                 / E)), K, min_capacity)
    logits = (tokens @ router).to(torch.float32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    if cfg.router == "expert_choice":
        out = _expert_choice(cfg, tokens, probs, experts, lo, capacity)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        out, frac_tokens = _gshard(cfg, tokens, probs, experts, lo,
                                   capacity, blocks)
        # Gathered, the means are the global batch's already.
        aux = _router_aux_loss(
            cfg, *(t if gather else block_mean(t)
                   for t in (frac_tokens, probs.mean(0))))
    if gather:
        # This rank's ep group's blocks (ep is the innermost batch axis),
        # their experts' parts summed over the group.
        first = index - index % ep
        out = out[first * T_own:(first + ep) * T_own]
        out = (_SumOwnRows.apply(out, group, ep, index - first) if ep > 1
               else out)
    elif ep > 1:  # a served batch: every rank holds the same rows
        from polyaxon_tpu_torch.parallel.tensor import _Reduce

        out = _Reduce.apply(out, group)
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
    return _moe_residual(cfg, llama._attn_residual(cfg, x, layer, positions),
                         layer)


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
    ce, acc = llama.lm_loss(cfg, _w(params["lm_head"], cfg.dtype), x,
                            tokens, batch.get("mask"))
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
        init=lambda generator, device, take=WHOLE: init(
            cfg, generator, device=device, take=take),
        apply=functools.partial(apply, cfg),
        unit="tokens",
        config=cfg,
        uniform_metrics=("router_aux",),
        sharded_init=True,
        logical_axes=functools.partial(logical_axes, cfg),
        layer_stacks=("layers",),
        tensor_parallel=True,
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
    for layer in llama._serving_layers(params):
        q, k, v = llama._qkv(cfg, layer, x, positions)
        attn = llama._attention(cfg, q, k, v)
        x = x + reduce_from_tp(attn.reshape(B, P, -1)
                               @ _w(layer["wo"], cfg.dtype))
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
    return llama._vocab_whole(cfg, logits), cache


def lm_head(cfg: MoEConfig, params: dict) -> torch.Tensor:
    """The [D, V] head table, dequantized whole if it is int8 (for a
    prompt pass, not a decode step)."""
    return _w(params["lm_head"], cfg.dtype)


def decode_logits(cfg: MoEConfig, params: dict,
                  x: torch.Tensor) -> torch.Tensor:
    return llama._vocab_whole(cfg, lm_logits(x, params["lm_head"], cfg.dtype,
                                             chunk=cfg.lm_logits_chunk))


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
    for i, layer in enumerate(llama._serving_layers(params)):
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
    for i, layer in enumerate(llama._serving_layers(params)):
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
    for i, layer in enumerate(llama._serving_layers(params)):
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
    for i, layer in enumerate(llama._serving_layers(params)):
        x, k, v = llama.suffix_attn_step(cfg, layer, x, k_prefix[i][None],
                                         v_prefix[i][None], positions, valid)
        x, _ = _moe_residual(cfg, x, layer, min_capacity=B * S)
        ks.append(k[0])
        vs.append(v[0])
    return torch.stack(ks), torch.stack(vs)
