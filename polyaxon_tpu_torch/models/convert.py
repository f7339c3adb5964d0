"""Checkpoint interop: a HuggingFace Llama state dict ↔ the port's llama
tree (port of ``polyaxon_tpu/models/convert.py``), and a params tree
read from an Orbax checkpoint of the JAX package → the port's store
(:func:`params_to_store`; ``scripts/convert_orbax_to_torch.py`` does the
Orbax half where JAX is installed).

Both sides use the rotate-half RoPE convention, so projections transfer
by transpose alone (HF ``[out, in]`` → ``[in, out]``), and per-layer
weights stack along a leading ``layers`` dim:

    model.embed_tokens.weight        [V, D]   → embed            [V, D]
    ...self_attn.{q,k,v}_proj.weight [O, D]   → w{q,k,v}         [D, O]
    ...self_attn.o_proj.weight       [D, HHd] → wo               [HHd, D]
    ...mlp.{gate,up}_proj.weight     [F, D]   → w_{gate,up}      [D, F]
    ...mlp.down_proj.weight          [D, F]   → w_down           [F, D]
    ...input_layernorm.weight        [D]      → attn_norm
    ...post_attention_layernorm      [D]      → mlp_norm
    model.norm.weight                [D]      → final_norm
    lm_head.weight                   [V, D]   → lm_head          [D, V]

Tensors come out f32 on the CPU, as the reference's arrays do.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from polyaxon_tpu_torch.models.llama import LlamaConfig

_LAYER_MAP = (
    ("input_layernorm.weight", "attn_norm", False),
    ("self_attn.q_proj.weight", "wq", True),
    ("self_attn.k_proj.weight", "wk", True),
    ("self_attn.v_proj.weight", "wv", True),
    ("self_attn.o_proj.weight", "wo", True),
    ("post_attention_layernorm.weight", "mlp_norm", False),
    ("mlp.gate_proj.weight", "w_gate", True),
    ("mlp.up_proj.weight", "w_up", True),
    ("mlp.down_proj.weight", "w_down", True),
)


def _to_numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().float().cpu().numpy()
    return np.asarray(value, dtype=np.float32)


def from_hf_llama(state_dict: Mapping[str, Any], cfg: LlamaConfig) -> dict:
    """HF LlamaForCausalLM state dict → ``{"params": ..., "state": {}}``."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    L = cfg.n_layers
    extra = f"model.layers.{L}.input_layernorm.weight"
    if extra in sd:
        raise ValueError(
            f"checkpoint has more than {L} layers (found `{extra}`) — "
            "cfg.n_layers does not match the state dict")

    def layer_stack(name: str, transpose: bool) -> torch.Tensor:
        mats = []
        for i in range(L):
            key = f"model.layers.{i}.{name}"
            if key not in sd:
                raise KeyError(f"HF state dict missing `{key}`")
            mats.append(sd[key].T if transpose else sd[key])
        return torch.from_numpy(np.ascontiguousarray(np.stack(mats)))

    params = {
        "embed": torch.from_numpy(sd["model.embed_tokens.weight"]),
        "layers": {ours: layer_stack(hf, transpose)
                   for hf, ours, transpose in _LAYER_MAP},
        "final_norm": torch.from_numpy(sd["model.norm.weight"]),
    }
    if not cfg.tie_embeddings:
        # HF tie_word_embeddings checkpoints ship no lm_head.
        head = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
        params["lm_head"] = torch.from_numpy(np.ascontiguousarray(head.T))
    return {"params": params, "state": {}}


def to_hf_llama(params: Mapping[str, Any], cfg: LlamaConfig
                ) -> dict[str, np.ndarray]:
    """The port's llama tree → HF LlamaForCausalLM state dict (numpy,
    contiguous: a transposed view would serialize untransposed)."""
    out: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _to_numpy(params["embed"]),
        "model.norm.weight": _to_numpy(params["final_norm"]),
    }
    layers = params["layers"]
    for i in range(cfg.n_layers):
        for hf, ours, transpose in _LAYER_MAP:
            mat = _to_numpy(layers[ours][i])
            out[f"model.layers.{i}.{hf}"] = (
                np.ascontiguousarray(mat.T) if transpose else mat)
    if "lm_head" in params:
        out["lm_head.weight"] = np.ascontiguousarray(
            _to_numpy(params["lm_head"]).T)
    return out


def _check_shapes(template: Mapping[str, Any], tree: Any, path: str = ""
                  ) -> None:
    """Raises ValueError unless ``tree`` has ``template``'s keys and
    leaf shapes."""
    if not isinstance(tree, Mapping) or set(tree) != set(template):
        got = sorted(tree) if isinstance(tree, Mapping) else type(tree)
        raise ValueError(f"params at '{path or '/'}' have keys {got}, the "
                         f"model expects {sorted(template)}")
    for key, ref in template.items():
        sub = f"{path}/{key}"
        if isinstance(ref, Mapping):
            _check_shapes(ref, tree[key], sub)
        elif tuple(np.shape(tree[key])) != tuple(ref.shape):
            raise ValueError(f"{sub} has shape {tuple(np.shape(tree[key]))}"
                             f", the model expects {tuple(ref.shape)}")


def params_to_store(params: Mapping[str, Any], model: str, directory: str,
                    step: int = 0) -> str:
    """Write a params tree of numpy arrays (bare, or a LoRA state's
    ``{"base", "lora"}`` with its ``_meta``) as committed step ``step``
    of the port's store under ``directory``, as ``{"params": ...}``, the
    layout ``serving.server.load_params`` reads (a LoRA state is merged
    there, as the port's own are). The tree (a LoRA state's ``base``)
    must have ``model``'s keys and shapes; dtypes are kept. Returns the
    step's directory."""
    from polyaxon_tpu_torch.models import family_of
    from polyaxon_tpu_torch.runtime.checkpoint import write_tree

    family = family_of(model)
    cfg = family.CONFIGS[model]
    template = family.init(cfg, torch.Generator(), device="meta",
                           param_dtype=cfg.dtype)["params"]
    lora = isinstance(params, Mapping) and set(params) == {"base", "lora"}
    _check_shapes(template, params["base"] if lora else params)
    return write_tree(directory, step, {"params": params})
