"""The port's training slice against the JAX package, on the CPU.

Losses, data streams, schedules and optimizers, the Llama training
forward and its gradients, gradient accumulation, a 5-step train-step
trajectory, the loop and its launcher. Weights are the JAX package's
initial ones, moved through numpy (``llama.params_from_numpy``); inputs
come from numpy seeds; everything is f32.

Tolerances:
- 1e-6 (relative 1e-6) where both sides run the same f32 elementwise
  arithmetic (schedules, one optimizer update);
- 1e-5 for losses and for the loss-level sums of two layers and a
  256-way vocabulary, taken in different orders by the two libraries;
- gradients of the whole model: atol 1e-5 + rtol 1e-4 (sums over every
  token of the batch, in different orders);
- the 5-step trajectory: 1e-4 on the loss, since Adam's normalised
  updates carry the f32 differences of each step into the next.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.models import common as jcommon
from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu.runtime import data as jdata
from polyaxon_tpu_torch.models import common as tcommon
from polyaxon_tpu_torch.models import get_model
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.runtime import data as tdata
from polyaxon_tpu_torch.runtime import optim as toptim
from polyaxon_tpu_torch.runtime.config import RuntimeConfig
from polyaxon_tpu_torch.runtime.loop import TrainResult, run_torchjob
from polyaxon_tpu_torch.runtime.step import build_init, build_train_step

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread is far faster than
    many on a shared host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def _packed(batch=2, seq=64, seed=0, i=0):
    it = jdata.lm_packed_synthetic(batch, seq_len=seq, vocab_size=256,
                                   mean_doc_len=16, seed=seed, start_batch=i)
    return next(it)


# ------------------------------------------------------------ losses
class TestLosses:
    def test_cross_entropy_and_shift_right(self):
        rng = np.random.default_rng(0)
        logits = rng.standard_normal((2, 9, 31)).astype(np.float32)
        labels = rng.integers(-1, 31, (2, 9)).astype(np.int32)
        mask = rng.integers(0, 2, (2, 9)).astype(np.int32)
        for m in (None, mask):
            want = jcommon.cross_entropy_loss(
                jnp.asarray(logits), jnp.asarray(labels),
                None if m is None else jnp.asarray(m))
            got = tcommon.cross_entropy_loss(
                torch.from_numpy(logits), torch.from_numpy(labels),
                None if m is None else torch.from_numpy(m))
            for g, w in zip(got, want):
                np.testing.assert_allclose(float(g), float(w), atol=1e-5,
                                           rtol=1e-5)
        np.testing.assert_array_equal(
            tcommon.shift_right(torch.from_numpy(labels)).numpy(),
            np.asarray(jcommon.shift_right(jnp.asarray(labels))))

    def test_chunked_lm_loss_value_and_grads(self):
        rng = np.random.default_rng(1)
        hidden = rng.standard_normal((2, 48, 16)).astype(np.float32)
        head = rng.standard_normal((16, 40)).astype(np.float32)
        labels = rng.integers(-1, 40, (2, 48)).astype(np.int32)
        mask = (rng.random((2, 48)) < 0.8).astype(np.int32)

        def jloss(h, w):
            loss, acc = jcommon.chunked_lm_loss(
                h, w, jnp.asarray(labels), jnp.asarray(mask), chunk=16)
            return loss, acc

        (jl, jacc), jg = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(hidden),
                                                  jnp.asarray(head))
        th = torch.tensor(hidden, requires_grad=True)
        tw = torch.tensor(head, requires_grad=True)
        tl, tacc = tcommon.chunked_lm_loss(th, tw, torch.from_numpy(labels),
                                           torch.from_numpy(mask), chunk=16)
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5,
                                   rtol=1e-5)
        assert tacc.item() == pytest.approx(float(jacc), abs=1e-6)
        np.testing.assert_allclose(th.grad.numpy(), _np(jg[0]), **GRAD_TOL)
        np.testing.assert_allclose(tw.grad.numpy(), _np(jg[1]), **GRAD_TOL)


# -------------------------------------------------------------- data
class TestData:
    @pytest.mark.parametrize("name", ["lm_synthetic", "lm_packed_synthetic"])
    def test_streams_are_byte_identical(self, name):
        kw = dict(batch_size=3, seq_len=96, vocab_size=1000, seed=5,
                  start_batch=2)
        jit, tit = jdata.get_dataset(name, **kw), tdata.get_dataset(name, **kw)
        for _ in range(2):
            a, b = next(jit), next(tit)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()

    def test_unported_and_unknown(self):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdata.get_dataset("lm_text_packed", batch_size=1)
        with pytest.raises(ValueError, match="Unknown"):
            tdata.get_dataset("nope", batch_size=1)
        assert tdata.dataset_for_model("llama_tiny") == \
            jdata.dataset_for_model("llama_tiny")

    def test_prefetch_keeps_order_and_surfaces_errors(self):
        def gen():
            yield from range(5)
            raise RuntimeError("boom")

        it = tdata.PrefetchIterator(gen(), depth=2)
        assert [next(it) for _ in range(5)] == list(range(5))
        with pytest.raises(RuntimeError, match="boom"):
            next(it)
        it.close()
        assert not it.alive
        batches = tdata.device_batches(tdata.host_batches(
            tdata.lm_packed_synthetic(2, seq_len=8, vocab_size=50), pin=False),
            "cpu")
        b = next(batches)
        assert b["tokens"].dtype == torch.int32 and b["segments"].shape == (2, 8)


# ---------------------------------------------------------- optimizer
def _rcfg(**kw):
    base = dict(model="llama_tiny", steps=10)
    base.update(kw)
    return RuntimeConfig.from_dict(base)


class TestOptim:
    @pytest.mark.parametrize("kind,warmup", [
        ("constant", 0), ("cosine", 0), ("linear", 0), ("cosine", 3),
        ("linear", 4), ("constant", 2)])
    def test_schedules_match_optax(self, kind, warmup):
        from polyaxon_tpu.runtime.optim import build_schedule

        cfg = _rcfg(lr_schedule=kind, warmup_steps=warmup,
                    learning_rate=0.5)
        want = build_schedule(cfg)
        got = toptim.build_schedule(cfg)
        for count in range(14):
            assert got(count) == pytest.approx(float(want(count)),
                                               rel=1e-6, abs=1e-7), count
        if warmup:
            assert got(0) == 0.0

    @pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
    @pytest.mark.parametrize("clip", [None, 1e-3, 100.0],
                             ids=["noclip", "clipped", "below"])
    def test_updates_match_optax(self, name, clip):
        from polyaxon_tpu.runtime.optim import build_optimizer

        cfg = _rcfg(optimizer=name, grad_clip_norm=clip, learning_rate=0.1,
                    lr_schedule="cosine", warmup_steps=1, weight_decay=0.1)
        rng = np.random.default_rng(2)
        params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
                  "b": {"c": rng.standard_normal(5).astype(np.float32)}}
        jopt = build_optimizer(cfg)
        jp = jax.tree.map(jnp.asarray, params)
        jstate = jopt.init(jp)
        topt = toptim.build_optimizer(cfg)
        tp = jax.tree.map(torch.tensor, params)
        tstate = topt.init(tp)
        for step in range(3):  # warmup (lr 0), then two real updates
            grads = jax.tree.map(
                lambda x: rng.standard_normal(x.shape).astype(np.float32),
                params)
            upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jp)
            jp = optax.apply_updates(jp, upd)
            topt.update(tp, [torch.tensor(g) for g in toptim.tree_leaves(
                grads)], tstate)
            for (key, w), (_, g) in zip(_flat(jp), _flat(tp)):
                np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-6,
                                           rtol=1e-6, err_msg=f"{key}@{step}")

    def test_clip_rule_is_optax(self):
        g = [torch.tensor([3.0, 4.0])]  # norm 5
        toptim.clip_by_global_norm(g, 5.0)  # norm >= max: scaled by 1
        assert g[0].tolist() == [3.0, 4.0]
        toptim.clip_by_global_norm(g, 1.0)
        np.testing.assert_allclose(g[0].numpy(), [0.6, 0.8], rtol=1e-6)

    @pytest.mark.parametrize("name", ["lion", "adafactor"])
    def test_unported_optimizers(self, name):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            toptim.build_optimizer(_rcfg(optimizer=name))


# -------------------------------------------------------------- model
_JAX_GRAD = {}


def _pair(name, **overrides):
    jcfg = dataclasses.replace(jllama.CONFIGS[name], dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(tllama.CONFIGS[name], dtype=torch.float32,
                               **overrides)
    jparams = jllama.init(jcfg, jax.random.key(0))["params"]
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tllama.params_from_numpy(tcfg, tree,
                                                         device="cpu")


def _jax_loss_and_grads(name, segments):
    """JAX's loss and grads (einsum attention, loss chunk 16), cached per
    (config, segments)."""
    key = (name, segments)
    if key not in _JAX_GRAD:
        jcfg, jparams, _, _ = _pair(name, loss_chunk=16)
        batch = _packed()
        if not segments:
            batch = {"tokens": batch["tokens"]}
        jbatch = jax.tree.map(jnp.asarray, batch)
        fn = jax.jit(jax.value_and_grad(
            lambda p: jllama.apply(jcfg, {"params": p, "state": {}},
                                   jbatch)[0]))
        loss, grads = fn(jparams)
        _JAX_GRAD[key] = (float(loss), dict(
            (k, _np(v)) for k, v in _flat(grads)), batch)
    return _JAX_GRAD[key]


def _torch_loss_and_grads(tcfg, tparams, batch):
    for t in toptim.tree_leaves(tparams):
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, _ = tllama.apply(tcfg, {"params": tparams, "state": {}},
                                    tbatch)
    loss.backward()
    return float(loss), {k: v.grad.numpy() for k, v in _flat(tparams)}


class TestModel:
    @pytest.mark.parametrize("impl", ["xla", "flash"])
    @pytest.mark.parametrize("segments", [False, True],
                             ids=["rows", "packed"])
    @pytest.mark.parametrize("name", ["llama_tiny", "llama_tiny_tied",
                                      "gemma_tiny"])
    def test_loss_and_grads_match_jax(self, name, segments, impl):
        want_loss, want, batch = _jax_loss_and_grads(name, segments)
        _, _, tcfg, tparams = _pair(name, loss_chunk=16)
        tcfg = dataclasses.replace(tcfg, attention_impl=impl)
        loss, got = _torch_loss_and_grads(tcfg, tparams, batch)
        assert loss == pytest.approx(want_loss, abs=1e-5, rel=1e-5)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **GRAD_TOL)

    def test_remat_modes_give_equal_grads(self):
        batch = _packed(seed=3)
        grads = {}
        for remat in ("none", "full", "dots"):
            _, _, tcfg, tparams = _pair("llama_tiny", remat=remat)
            tcfg = dataclasses.replace(tcfg, attention_impl="flash")
            grads[remat] = _torch_loss_and_grads(tcfg, tparams, batch)
        for remat in ("full", "dots"):
            assert grads[remat][0] == pytest.approx(grads["none"][0],
                                                    abs=1e-6)
            for key, g in grads["none"][1].items():
                np.testing.assert_allclose(grads[remat][1][key], g,
                                           atol=1e-6, rtol=1e-6)

    def test_segment_positions_and_starts(self):
        seg = np.array([[0, 0, 0, 1, 1, 2], [0, 1, 1, 1, 1, 1]], np.int32)
        np.testing.assert_array_equal(
            tllama.segment_positions(torch.from_numpy(seg)).numpy(),
            np.asarray(jllama.segment_positions(jnp.asarray(seg))))
        np.testing.assert_array_equal(
            tllama.segment_starts(torch.from_numpy(seg)).numpy(),
            np.asarray(jllama.segment_starts(jnp.asarray(seg))))

    def test_refusals(self):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_model("llama_tiny", pipeline_stages=2)
        with pytest.raises(NotImplementedError, match="item 6"):
            get_model("moe_tiny")
        with pytest.raises(ValueError, match="remat"):
            tllama.hidden_states(dataclasses.replace(
                tllama.CONFIGS["llama_tiny"], remat="most"),
                tllama.init(tllama.CONFIGS["llama_tiny"],
                            torch.Generator().manual_seed(0),
                            device="cpu")["params"],
                torch.zeros(1, 4, dtype=torch.long))
        # A training config on the card whose head_dim no kernel takes is
        # refused at construction; serving checks only the forward and
        # decode kernels, and the explicit plain backward takes any
        # head_dim. gemma_2b's head_dim 256 now has backward kernels.
        odd = dataclasses.replace(tllama.CONFIGS["llama_200m"],
                                  attention_impl="flash", n_heads=8,
                                  n_kv_heads=4, dim=768)
        assert odd.head_dim == 96
        with pytest.raises(ValueError, match="flash_fwd"):
            tllama.check_kernel_shapes(odd, "cuda", training=True)
        tllama.check_kernel_shapes(odd, "cpu", training=True)
        gemma = dataclasses.replace(tllama.CONFIGS["gemma_2b"],
                                    attention_impl="flash")
        assert gemma.head_dim == 256
        tllama.check_kernel_shapes(gemma, "cuda", training=True)
        tllama.check_kernel_shapes(gemma, "cuda", training=False)
        tllama.check_kernel_shapes(dataclasses.replace(
            gemma, flash_bwd_impl="xla"), "cuda", training=True)


# ----------------------------------------------------------- training
def _trajectory_cfg():
    return dict(model="llama_tiny", steps=5, optimizer="adamw",
                learning_rate=3e-3, lr_schedule="cosine", warmup_steps=1,
                grad_clip_norm=1.0, weight_decay=0.01)


class TestTrainStep:
    def test_accumulation_equals_full_batch(self):
        """accum_steps=2 == accum_steps=1, with uneven valid-token counts
        per microbatch (mask weighting) and packed segments."""
        batch = _packed(batch=4, seed=4)
        mask = np.ones((4, 64), np.int32)
        mask[2:, 10:] = 0
        batch["mask"] = mask
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        out = {}
        for accum in (1, 2):
            model_def = get_model("llama_tiny", dtype=torch.float32,
                                  attention_impl="flash", loss_chunk=16)
            opt = toptim.build_optimizer(RuntimeConfig.from_dict(
                dict(_trajectory_cfg(), optimizer="sgd")))
            state = build_init(model_def, opt, device="cpu")(0)
            state, metrics = build_train_step(model_def, opt, accum)(
                state, tbatch)
            out[accum] = (metrics, dict(_flat(state["params"])))
        for key in ("loss", "accuracy", "grad_norm"):
            assert float(out[2][0][key]) == pytest.approx(
                float(out[1][0][key]), abs=1e-5)
        for key, p in out[1][1].items():
            np.testing.assert_allclose(out[2][1][key].detach().numpy(),
                                       p.detach().numpy(), atol=1e-6,
                                       err_msg=key)

    def test_trajectory_matches_jax(self, cpu_devices):
        """Five adamw steps (a warmup step at lr 0, cosine, clipping) of
        llama_tiny from JAX's initial weights and the same packed
        batches: the port's train step against JAX's on a 1-device
        mesh."""
        _check_trajectory(cpu_devices, "llama_tiny")

    def test_gemma_head_dim_256_trajectory_matches_jax(self, cpu_devices):
        """The same at gemma's conventions (tied embeddings, GeGLU, (1+w)
        norms, scaled embeddings) and gemma_2b's head_dim 256 and MQA:
        dim 512, 2 q heads, 1 kv head, 2 layers, through the port's flash
        attention."""
        assert dataclasses.replace(tllama.CONFIGS["gemma_tiny"],
                                   **GEMMA_HD256).head_dim == 256
        _check_trajectory(cpu_devices, "gemma_tiny", steps=3,
                          **GEMMA_HD256)


# gemma_tiny widened to gemma_2b's head_dim (512 / 2 = 256) and MQA.
GEMMA_HD256 = dict(dim=512, n_heads=2, n_kv_heads=1, ffn_dim=256)


def _check_trajectory(cpu_devices, name, steps=5, **overrides):
    from polyaxon_tpu.parallel import build_mesh, rules_for_mesh
    from polyaxon_tpu.runtime.config import RuntimeConfig as JCfg
    from polyaxon_tpu.runtime.optim import build_optimizer as jbuild
    from polyaxon_tpu.runtime.step import build_init as jinit
    from polyaxon_tpu.runtime.step import build_train_step as jstep

    spec = dict(_trajectory_cfg(), model=name, steps=steps)
    batches = [_packed(batch=4, seed=6, i=i) for i in range(steps)]
    mesh = build_mesh(axes={"dp": 1}, devices=cpu_devices[:1])
    rules = rules_for_mesh(mesh)
    jmodel = jllama.model_def(name, dtype=jnp.float32, loss_chunk=16,
                              **overrides)
    jopt = jbuild(JCfg(**spec))
    with mesh:
        jstate = jinit(jmodel, jopt, mesh, rules)(jax.random.key(0))
        params0 = jax.tree.map(np.asarray, jstate["params"])
        train = jstep(jmodel, jopt, mesh, rules)
        want = []
        for b in batches:
            jstate, m = train(jstate, jax.tree.map(jnp.asarray, b),
                              jax.random.key(1))
            want.append((float(m["loss"]), float(m["grad_norm"])))

    model_def = get_model(name, dtype=torch.float32, attention_impl="flash",
                          loss_chunk=16, **overrides)
    opt = toptim.build_optimizer(RuntimeConfig.from_dict(spec))
    params = tllama.params_from_numpy(model_def.config, params0,
                                      device="cpu")
    state = build_init(model_def, opt, device="cpu", params=params)(0)
    step = build_train_step(model_def, opt)
    for b, (loss, gnorm) in zip(batches, want):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        assert float(m["loss"]) == pytest.approx(loss, abs=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(gnorm, rel=1e-4)


# ------------------------------------------------------------ runtime
def _job(**runtime):
    spec = dict(model="llama_tiny", dataset="lm_packed_synthetic", seq_len=32,
                global_batch_size=4, grad_accum_steps=2, steps=3,
                log_every=1, eval_every=2, eval_steps=1, remat="dots",
                attention_impl="flash", lr_schedule="cosine", loss_chunk=16)
    spec.update(runtime)
    return {"kind": "jaxjob", "runtime": spec,
            "mesh": {"axes": {"fsdp": -1}},
            "checkpointing": {"enabled": False}}


class TestRuntime:
    def test_run_torchjob_on_cpu(self, tmp_path):
        seen = []
        result = run_torchjob(_job(), artifacts_dir=str(tmp_path),
                              on_metrics=lambda s, v: seen.append((s, v)),
                              device="cpu")
        assert isinstance(result, TrainResult)
        assert result.steps == 3 and result.unit == "tokens"
        assert result.units_per_step == 4 * 32
        train = [v for _, v in seen if "loss" in v]
        assert [s for s, v in seen if "loss" in v] == [1, 2]
        for key in ("loss", "accuracy", "grad_norm", "tokens_per_sec",
                    "step_time_ms", "input_wait_ms",
                    "tflops_per_sec_per_chip"):
            assert all(np.isfinite(v[key]) for v in train), key
        assert "compile_time_s" in train[0]
        assert "mfu" not in train[0]  # no peak for the CPU
        assert any("eval_loss" in v for _, v in seen)
        assert np.isfinite(result.final_metrics["eval_loss"])

    def test_should_stop_and_refusals(self, tmp_path):
        result = run_torchjob(_job(steps=10, eval_every=None),
                              should_stop=lambda: True, device="cpu")
        assert result.steps == 1  # the warm-up step only
        for job, exc, match in (
                (dict(_job(), mesh={"axes": {"dp": 2}}), ValueError, "one"),
                (_job(lora_rank=4), NotImplementedError, "ROADMAP")):
            with pytest.raises(exc, match=match):
                run_torchjob(job, artifacts_dir=str(tmp_path), device="cpu")
        # Checkpointing and profile_steps are ported: no refusal, and
        # should_stop still ends the run after the warm-up step.
        job = dict(_job(steps=10, eval_every=None, profile_steps=[1]),
                   checkpointing={"enabled": True})
        result = run_torchjob(job, artifacts_dir=str(tmp_path),
                              should_stop=lambda: True, device="cpu")
        assert result.steps == 1 and result.restored_from_step is None
        assert os.listdir(tmp_path / "checkpoints" / "1")

    def test_entry_points_need_a_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            run_torchjob(_job())

    def test_launcher_exit_codes(self, tmp_path, monkeypatch, capsys):
        from polyaxon_tpu_torch.runtime import launch

        monkeypatch.delenv("POLYAXON_JAXJOB_SPEC", raising=False)
        assert launch.main() == 2
        monkeypatch.setenv("POLYAXON_JAXJOB_SPEC",
                           json.dumps({"runtime": {}}))
        monkeypatch.setenv("POLYAXON_RUN_ARTIFACTS_PATH", str(tmp_path))
        assert launch.main() == 1
        assert "Traceback" in capsys.readouterr().err


def test_lib_path_follows_included_headers(tmp_path, monkeypatch):
    from polyaxon_tpu_torch.ops import _build

    for name in ("flash_bwd.cu", "sm90_bf16.cuh"):
        (tmp_path / name).write_bytes(open(os.path.join(_build.CSRC, name),
                                           "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = _build._lib_path("flash_bwd")
    assert _build._sources("flash_bwd") == ["flash_bwd.cu", "sm90_bf16.cuh"]
    with open(tmp_path / "sm90_bf16.cuh", "a") as fh:
        fh.write("// edited\n")
    assert _build._lib_path("flash_bwd") != before
