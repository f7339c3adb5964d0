"""T5-style encoder-decoder seq2seq family (port of
``polyaxon_tpu/models/t5.py``).

- The encoder is ``models/encoder.py``'s stack with learned positions
  (``enc_pos``) and a final RMSNorm. It forwards ``attention_impl``, so
  on CUDA its attention is the **non-causal** flash forward and backward.
- The decoder: pre-RMSNorm causal self-attention with RoPE (the flash
  kernels on CUDA, as in llama), cross-attention over the encoder output
  (einsum, ``impl="xla"``, as the reference runs it), and a gated-GELU
  FFN (T5.1.1 style).
- The loss is ``common.chunked_lm_loss`` over the decoder's hidden
  states.

Serving: ``generate`` runs the encoder once and steps the decoder from
BOS through a dense cache. The continuous-batching hooks keep per-slot
encoder state in the pool cache (cross-attention K/V padded to
``max_seq_len`` and a length mask), so requests with different encoder
lengths share one ragged decoder step. There is no paged surface and no
``decode_chunk``, in either package: the paged engine, chunked prefill
and speculation refuse t5.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from polyaxon_tpu_torch.models import encoder
from polyaxon_tpu_torch.models.common import (
    ModelDef,
    Variables,
    _embed_rows,
    _w,
    chunked_lm_loss,
    gelu,
    lm_logits,
    remat_body,
    rms_norm,
    rope,
    sample_logits,
    scaled_init,
    shift_right,
    tree_from_numpy,
    truncated_normal_init,
    unstack,
)
from polyaxon_tpu_torch.ops.attention import NEG_INF, dot_product_attention

SEQ2SEQ = True  # serving contract: prompt = encoder input, decode from BOS
BOS_ID = 0  # decoder start token (generate()'s default)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32_128
    dim: int = 768
    n_layers: int = 12        # per stack (encoder and decoder)
    n_heads: int = 12
    ffn_dim: int = 2048
    max_seq_len: int = 512
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: str = "none"
    # "auto" = the flash kernels on CUDA tensors, einsum on the CPU (the
    # port's default, as for llama; the reference's is "xla").
    attention_impl: str = "auto"
    loss_chunk: int = 256
    lm_logits_chunk: int = 4096

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def encoder_config(self) -> encoder.EncoderConfig:
        return encoder.EncoderConfig(
            dim=self.dim, n_layers=self.n_layers, n_heads=self.n_heads,
            ffn_dim=self.ffn_dim, dtype=self.dtype, remat=self.remat,
            attention_impl=self.attention_impl,
        )


CONFIGS: dict[str, T5Config] = {
    "t5_base": T5Config(),
    "t5_small": T5Config(dim=512, n_layers=6, n_heads=8, ffn_dim=1024),
    "t5_tiny": T5Config(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        ffn_dim=128, max_seq_len=64),
}

_GAINS = ("self_norm", "cross_norm", "mlp_norm", "enc_norm", "dec_norm",
          *encoder.GAINS)


def init(cfg: T5Config, generator: torch.Generator, *, device,
         param_dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters from ``generator`` (the JAX ``init``'s shapes and
    scales; the draws differ)."""
    L, D, F_, H, Hd = (cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_heads,
                       cfg.head_dim)

    def stacked(shape, fan_in):
        out = torch.empty((L, *shape), dtype=param_dtype, device=device)
        for i in range(L):
            out[i] = scaled_init(shape, generator, device=device,
                                 dtype=param_dtype, fan_in=fan_in)
        return out

    def gain(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    params = {
        "embed": truncated_normal_init((cfg.vocab_size, D), generator,
                                       device=device, dtype=param_dtype),
        # The shared encoder block carries no positional information.
        "enc_pos": truncated_normal_init((cfg.max_seq_len, D), generator,
                                         device=device, dtype=param_dtype),
        "enc_layers": encoder.init_layers(cfg.encoder_config(), generator,
                                          device=device,
                                          param_dtype=param_dtype),
        "enc_norm": gain(D),
        "dec_layers": {
            "self_norm": gain(L, D),
            "wq": stacked((D, H * Hd), D),
            "wk": stacked((D, H * Hd), D),
            "wv": stacked((D, H * Hd), D),
            "wo": stacked((H * Hd, D), H * Hd),
            "cross_norm": gain(L, D),
            "xq": stacked((D, H * Hd), D),
            "xkv": stacked((D, 2 * H * Hd), D),
            "xo": stacked((H * Hd, D), H * Hd),
            "mlp_norm": gain(L, D),
            "w_gate": stacked((D, F_), D),
            "w_up": stacked((D, F_), D),
            "w_down": stacked((F_, D), F_),
        },
        "dec_norm": gain(D),
        "lm_head": truncated_normal_init((D, cfg.vocab_size), generator,
                                         device=device, dtype=param_dtype),
    }
    return {"params": params, "state": {}}


def params_from_numpy(cfg: T5Config, tree: dict, *, device,
                      param_dtype: torch.dtype = torch.float32) -> dict:
    """JAX parameters as numpy arrays → port tensors (identity map;
    norm gains f32)."""
    del cfg
    return tree_from_numpy(tree, device=device, param_dtype=param_dtype,
                           f32_names=_GAINS)


def check_kernel_shapes(cfg: T5Config, device, *, training: bool = False,
                        paged: bool = False) -> None:
    """On CUDA, raise at construction if the flash kernels that the
    encoder and the decoder's self-attention launch cannot take the
    head_dim. t5 has no paged decode."""
    del paged
    if torch.device(device).type != "cuda":
        return
    from polyaxon_tpu_torch.ops import flash

    if cfg.attention_impl in ("auto", "flash") and (
            cfg.head_dim not in flash.KERNEL_HEAD_DIMS):
        raise ValueError(
            f"the flash kernels take head_dim in {flash.KERNEL_HEAD_DIMS}; "
            f"this config has {cfg.head_dim}"
            + (" (training)" if training else ""))


def _cross_kv(cfg: T5Config, layer: dict, enc_out: torch.Tensor):
    B, Se, _ = enc_out.shape
    H, Hd = cfg.n_heads, cfg.head_dim
    k, v = (enc_out @ _w(layer["xkv"], cfg.dtype)).chunk(2, dim=-1)
    return k.reshape(B, Se, H, Hd), v.reshape(B, Se, H, Hd)


def _ffn(cfg: T5Config, x: torch.Tensor, layer: dict) -> torch.Tensor:
    dt = cfg.dtype
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gate = gelu(h @ _w(layer["w_gate"], dt))
    up = h @ _w(layer["w_up"], dt)
    return x + (gate * up) @ _w(layer["w_down"], dt)


def _decoder_layer(cfg: T5Config, x: torch.Tensor, enc_out: torch.Tensor,
                   layer: dict, positions: torch.Tensor) -> torch.Tensor:
    B, S, D = x.shape
    H, Hd = cfg.n_heads, cfg.head_dim
    dt = cfg.dtype
    # Causal self-attention with RoPE.
    h = rms_norm(x, layer["self_norm"], cfg.norm_eps)
    q = rope((h @ _w(layer["wq"], dt)).reshape(B, S, H, Hd), positions,
             cfg.rope_theta)
    k = rope((h @ _w(layer["wk"], dt)).reshape(B, S, H, Hd), positions,
             cfg.rope_theta)
    v = (h @ _w(layer["wv"], dt)).reshape(B, S, H, Hd)
    attn = dot_product_attention(q, k, v, causal=True,
                                 impl=cfg.attention_impl)
    x = x + attn.reshape(B, S, H * Hd) @ _w(layer["wo"], dt)
    # Cross-attention over the encoder output (no RoPE), einsum as in the
    # reference.
    h = rms_norm(x, layer["cross_norm"], cfg.norm_eps)
    q = (h @ _w(layer["xq"], dt)).reshape(B, S, H, Hd)
    k, v = _cross_kv(cfg, layer, enc_out)
    attn = dot_product_attention(q, k, v, causal=False, impl="xla")
    x = x + attn.reshape(B, S, H * Hd) @ _w(layer["xo"], dt)
    return _ffn(cfg, x, layer)


def encode(cfg: T5Config, params: dict, inputs: torch.Tensor) -> torch.Tensor:
    """Input token ids [B, Se] → encoder states [B, Se, D]."""
    dt = cfg.dtype
    Se = inputs.shape[1]
    x = (_embed_rows(params["embed"], inputs, dt)
         + _w(params["enc_pos"], dt)[None, :Se])
    x = encoder.encode(cfg.encoder_config(), params["enc_layers"], x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_hidden(cfg: T5Config, params: dict, enc_out: torch.Tensor,
                  targets_in: torch.Tensor) -> torch.Tensor:
    """Decoder input ids [B, Sd] + encoder states → hidden [B, Sd, D]."""
    B, S = targets_in.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=targets_in.device)[None].expand(B, S)
    x = _embed_rows(params["embed"], targets_in, cfg.dtype)
    body = remat_body(functools.partial(_decoder_layer, cfg), cfg.remat)
    for layer in unstack(params["dec_layers"]):
        x = body(x, enc_out, layer, positions)
    return rms_norm(x, params["dec_norm"], cfg.norm_eps)


def forward(cfg: T5Config, params: dict, inputs: torch.Tensor,
            targets_in: torch.Tensor) -> torch.Tensor:
    """(input ids, decoder-input ids) → f32 logits [B, Sd, vocab]."""
    enc_out = encode(cfg, params, inputs)
    x = decode_hidden(cfg, params, enc_out, targets_in)
    return (x @ _w(params["lm_head"], cfg.dtype)).to(torch.float32)


def apply(cfg: T5Config, variables: Variables, batch: dict,
          train: bool = True, rng=None):
    """Seq2seq loss of ``batch["targets"]`` given ``batch["inputs"]``
    (decoder inputs are the targets shifted right from BOS)."""
    params = variables["params"]
    inputs, targets = batch["inputs"], batch["targets"]
    enc_out = encode(cfg, params, inputs)
    x = decode_hidden(cfg, params, enc_out, shift_right(targets))
    head = _w(params["lm_head"], cfg.dtype)
    loss, acc = chunked_lm_loss(x, head, targets, batch.get("mask"),
                                chunk=cfg.loss_chunk)
    return loss, {"loss": loss, "accuracy": acc}, variables["state"]


def _decoder_logical_axes() -> dict:
    return {
        "self_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "heads"),
        "wv": ("layers", "embed", "heads"),
        "wo": ("layers", "heads", "embed"),
        "cross_norm": ("layers", "embed"),
        "xq": ("layers", "embed", "heads"),
        "xkv": ("layers", "embed", "heads"),
        "xo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }


def logical_axes(cfg: T5Config) -> Variables:
    return {
        "params": {
            "embed": ("vocab", "embed"),
            "enc_pos": ("seq", "embed"),
            "enc_layers": encoder.layers_logical_axes(),
            "enc_norm": ("embed",),
            "dec_layers": _decoder_logical_axes(),
            "dec_norm": ("embed",),
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
        logical_axes=functools.partial(logical_axes, cfg),
        layer_stacks=("enc_layers", "dec_layers"),
    )


# ---------------------------------------------------------------- decode
def _serving_layers(params: dict):
    """The decoder's per-layer views for a serving pass, each layer's
    fsdp shards gathered where its turn comes (``parallel/fsdp.py``)."""
    from polyaxon_tpu_torch.parallel.fsdp import gathered

    return (gathered(layer) for layer in unstack(params["dec_layers"]))


def precompute_cross_kv(cfg: T5Config, params: dict,
                        enc_out: torch.Tensor) -> dict:
    """Cross-attention K/V of the encoder output, once per request:
    {k, v: [L, B, Se, H, Hd]}."""
    ks, vs = [], []
    for layer in _serving_layers(params):
        k, v = _cross_kv(cfg, layer, enc_out)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def init_decoder_cache(cfg: T5Config, batch: int, max_len: int, *,
                       device) -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _masked_attention(cfg: T5Config, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """q [B, 1, H, Hd] over k/v [B, C, H, Hd] with ``valid``
    [B, 1, 1, C]: f32 logits and softmax, the products in the compute
    dtype (the reference's einsums)."""
    B, _, H, Hd = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    s = torch.where(valid, s * (Hd ** -0.5), torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(cfg.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, 1, H * Hd)


def decode_step_ragged(cfg: T5Config, params: dict, cache: dict,
                       tokens: torch.Tensor,
                       pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decoder step with per-row positions (-1 = idle) over the
    slot-pool cache (``cb_init_cache``'s layout), its self-KV updated in
    place. Idle rows are masked in both attentions; the decoder cache is
    full-causal, and admission guarantees pos < its length."""
    dt = cfg.dtype
    B = tokens.shape[0]
    H, Hd = cfg.n_heads, cfg.head_dim
    C = cache["k"].shape[2]
    dev = tokens.device
    pos = pos.to(dev)
    pos_safe = pos.clamp(min=0).long()
    positions = pos_safe[:, None]
    rows = torch.arange(B, device=dev)
    live = (pos >= 0)[:, None]
    valid = ((torch.arange(C, device=dev)[None, :] <= pos_safe[:, None])
             & live)[:, None, None, :]
    xvalid = (cache["xmask"] & live)[:, None, None, :]
    x = _embed_rows(params["embed"], tokens, dt)[:, None, :]
    for i, layer in enumerate(_serving_layers(params)):
        h = rms_norm(x, layer["self_norm"], cfg.norm_eps)
        q = rope((h @ _w(layer["wq"], dt)).reshape(B, 1, H, Hd), positions,
                 cfg.rope_theta)
        k = rope((h @ _w(layer["wk"], dt)).reshape(B, 1, H, Hd), positions,
                 cfg.rope_theta)
        v = (h @ _w(layer["wv"], dt)).reshape(B, 1, H, Hd)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[rows, pos_safe] = k[:, 0]
        v_cache[rows, pos_safe] = v[:, 0]
        attn = _masked_attention(cfg, q, k_cache, v_cache, valid)
        x = x + attn @ _w(layer["wo"], dt)

        h = rms_norm(x, layer["cross_norm"], cfg.norm_eps)
        q = (h @ _w(layer["xq"], dt)).reshape(B, 1, H, Hd)
        attn = _masked_attention(cfg, q, cache["xk"][i], cache["xv"][i],
                                 xvalid)
        x = x + attn @ _w(layer["xo"], dt)
        x = _ffn(cfg, x, layer)
    x = rms_norm(x, params["dec_norm"], cfg.norm_eps)
    logits = lm_logits(x[:, 0], params["lm_head"], dt,
                       chunk=cfg.lm_logits_chunk)
    return logits, cache


def decode_step(cfg: T5Config, params: dict, cross: dict, cache: dict,
                tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict]:
    """One decoder step with every row at ``pos`` (< the cache length):
    ``decode_step_ragged`` over the cross state packed with a full
    mask."""
    B = tokens.shape[0]
    C = cache["k"].shape[2]
    if int(pos) >= C:
        raise ValueError(f"decode position {pos} out of cache range {C}")
    Se = cross["k"].shape[2]
    pool = {"k": cache["k"], "v": cache["v"], "xk": cross["k"],
            "xv": cross["v"],
            "xmask": torch.ones((B, Se), dtype=torch.bool,
                                device=tokens.device)}
    logits, _ = decode_step_ragged(
        cfg, params, pool, tokens,
        torch.full((B,), int(pos), dtype=torch.long, device=tokens.device))
    return logits, cache


def generate(cfg: T5Config, params: dict, inputs: torch.Tensor, *,
             max_new_tokens: int, bos_id: int = BOS_ID,
             temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature 0) or sampled seq2seq generation from encoder
    inputs [B, Se]: [B, max_new]. The encoder runs once; the decoder
    steps from BOS through its cache."""
    B = inputs.shape[0]
    sampling = temperature > 0
    if sampling and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    enc_out = encode(cfg, params, inputs)
    cross = precompute_cross_kv(cfg, params, enc_out)
    cache = init_decoder_cache(cfg, B, max_new_tokens, device=inputs.device)
    token = torch.full((B,), bos_id, dtype=torch.long, device=inputs.device)
    out = []
    for t in range(max_new_tokens):
        logits, cache = decode_step(cfg, params, cross, cache, token, t)
        token = (sample_logits(logits, generator, temperature, top_p, top_k)
                 if sampling else logits.argmax(dim=-1)).to(torch.long)
        out.append(token)
    return torch.stack(out, dim=1)


# ------------------------------------------- continuous batching surface
def cb_validate(cfg: T5Config, prompt_len: int, max_new: int,
                max_len: int) -> None:
    """Seq2seq budget rule: the encoder prompt is bounded by the model's
    max_seq_len, the decode budget by the pool's decoder cache."""
    if prompt_len > cfg.max_seq_len:
        raise ValueError(f"encoder prompt {prompt_len} exceeds max_seq_len "
                         f"{cfg.max_seq_len}")
    if max_new > max_len:
        raise ValueError(f"max_new_tokens {max_new} exceeds decoder budget "
                         f"{max_len}")


def cb_init_cache(cfg: T5Config, slots: int, max_len: int, *,
                  device) -> dict:
    dec = init_decoder_cache(cfg, slots, max_len, device=device)
    shape = (cfg.n_layers, slots, cfg.max_seq_len, cfg.n_heads, cfg.head_dim)
    return {"k": dec["k"], "v": dec["v"],
            "xk": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "xv": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "xmask": torch.zeros((slots, cfg.max_seq_len), dtype=torch.bool,
                                 device=device)}


def cb_prefill(cfg: T5Config, params: dict, prompt: torch.Tensor,
               max_len: int) -> dict:
    """Admission work for one request: the encoder once, its
    cross-attention K/V padded to the pool's encoder bound, fresh
    decoder self-KV rows."""
    enc_out = encode(cfg, params, prompt)
    cross = precompute_cross_kv(cfg, params, enc_out)  # [L, 1, P, H, Hd]
    P = prompt.shape[1]
    row = cb_init_cache(cfg, 1, max_len, device=prompt.device)
    row["xk"][:, :, :P] = cross["k"]
    row["xv"][:, :, :P] = cross["v"]
    row["xmask"][:, :P] = True
    return row


def cb_admission(prompt: list) -> tuple:
    """(decoder start position, first decoder token, prefill tokens):
    the whole prompt feeds the encoder; decoding starts at BOS/pos 0."""
    return 0, BOS_ID, list(prompt)


def insert_cache_row(cache: dict, row: dict, b: int) -> dict:
    """Copy a one-row pool cache into row ``b``, in place."""
    for key in ("k", "v", "xk", "xv"):
        cache[key][:, b] = row[key][:, 0]
    cache["xmask"][b] = row["xmask"][0]
    return cache
