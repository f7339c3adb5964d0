"""The port's parallel layer as data, held equal to the JAX package's on
the 8-device CPU mesh (no processes): mesh parsing, aliases, order and
the size mismatch; the emulated multi-slice device order and the
one-device mesh; every case of ``tests/test_parallel.py``'s
``TestRules``; each model family's logical axes and their specs under
each strategy, entry by entry; the batch spec and batch axes; placements;
the bootstrap's env contract. Then the one-rank group of an in-process
run: started and destroyed, ring and Ulysses at cp = 1, a placed state.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from polyaxon_tpu.parallel import build_mesh as jbuild_mesh
from polyaxon_tpu.parallel import logical_to_spec as jspec
from polyaxon_tpu.parallel import mesh as jmesh
from polyaxon_tpu.parallel import rules_for_mesh as jrules
from polyaxon_tpu.parallel import sharding as jsharding
from polyaxon_tpu.parallel.bootstrap import read_env_contract as jcontract
from polyaxon_tpu.polyflow import V1MeshSpec as JMeshSpec
from polyaxon_tpu.polyflow import V1TpuTopology as JTopology
from polyaxon_tpu_torch.parallel import bootstrap, mesh as tmesh
from polyaxon_tpu_torch.parallel import sharding as tsharding
from polyaxon_tpu_torch.parallel.sharding import (FSDP_RULES, TP_RULES,
                                                  logical_to_spec,
                                                  merge_rules,
                                                  rules_for_mesh,
                                                  tree_placements)
from polyaxon_tpu_torch.polyflow import V1MeshSpec, V1TpuTopology

RANKS = range(8)


def _both(axes=None, spec=None, topo=None, cpu_devices=None):
    """The same mesh from both packages (the port's over ranks 0..7)."""
    jm = jbuild_mesh(JMeshSpec(**spec) if spec else None,
                     JTopology(**topo) if topo else None, axes=axes,
                     devices=cpu_devices)
    tm = tmesh.build_mesh(V1MeshSpec(**spec) if spec else None,
                          V1TpuTopology(**topo) if topo else None, axes=axes,
                          devices=RANKS)
    return jm, tm


def _ids(jm) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(jm.devices)


class TestMesh:
    @pytest.mark.parametrize("kwargs", [
        dict(spec={"axes": {"dp": 2, "fsdp": 4}}),
        dict(spec={"axes": {"dp": 2, "fsdp": -1}}),
        dict(axes={"model": 2, "data": 4}),
        dict(axes={"cp": 4, "dp": 2}),
        dict(axes={"tp": 2, "fsdp": 2, "dp": 2}),
    ])
    def test_layout_equals_jax(self, kwargs, cpu_devices):
        jm, tm = _both(cpu_devices=cpu_devices, **kwargs)
        assert tm.axis_names == jm.axis_names
        assert tm.shape == dict(zip(jm.axis_names, jm.devices.shape))
        np.testing.assert_array_equal(tm.devices, _ids(jm))

    def test_hybrid_multislice_order_equals_jax(self, cpu_devices, caplog):
        """2 slices of 4: dp over DCN, slowest-varying, as the JAX
        package emulates slices for devices without a slice index."""
        kwargs = dict(spec={"axes": {"fsdp": 4, "dp": 2},
                            "dcn_axes": ["dp"]},
                      topo={"accelerator": "v5e", "topology": "2x2",
                            "slices": 2})
        with caplog.at_level("INFO"):
            jm, tm = _both(cpu_devices=cpu_devices, **kwargs)
        np.testing.assert_array_equal(tm.devices, _ids(jm))
        assert "hybrid mesh: dcn_axes=['dp']" in caplog.text
        assert tmesh.mesh_summary(tm) == {
            "axes": {"dp": 2, "fsdp": 4}, "n_devices": 8, "platform": "cpu",
            "device_kind": "cpu"}

    def test_size_mismatch_message_equals_jax(self, cpu_devices):
        with pytest.raises(ValueError) as jerr:
            jbuild_mesh(axes={"dp": 3}, devices=cpu_devices)
        with pytest.raises(ValueError) as terr:
            tmesh.build_mesh(axes={"dp": 3}, devices=RANKS)
        assert str(terr.value) == str(jerr.value)

    @pytest.mark.parametrize("text", [
        "tp=4,dp=2", "fsdp=-1", "tp=4,tp=2", "tp", "tp=x", "=4", "dp=2, cp=4",
    ])
    def test_parse_mesh_axes_equals_jax(self, text):
        try:
            want = jmesh.parse_mesh_axes(text)
        except ValueError as exc:
            with pytest.raises(ValueError) as err:
                tmesh.parse_mesh_axes(text)
            assert str(err.value) == str(exc)
        else:
            assert tmesh.parse_mesh_axes(text) == want

    def test_single_device_mesh_equals_jax(self):
        for axis in ("dp", "cp"):
            jm, tm = jmesh.single_device_mesh(axis), \
                tmesh.single_device_mesh(axis)
            assert tm.axis_names == jm.axis_names
            assert tm.shape == dict(zip(jm.axis_names, jm.devices.shape))
            np.testing.assert_array_equal(tm.devices, _ids(jm))

    def test_aliases_and_order(self):
        axes = {"expert": 2, "seq": 2, "data": 2, "x": 1}
        assert tmesh.canonical_axes(axes) == jmesh.canonical_axes(axes)
        assert tmesh.order_axes(tmesh.canonical_axes(axes)) == \
            jmesh.order_axes(jmesh.canonical_axes(axes))
        assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
        with pytest.raises(ValueError, match="Duplicate mesh axis"):
            tmesh.canonical_axes({"data": 2, "dp": 2})


class TestRules:
    """``tests/test_parallel.py``'s ``TestRules`` on the port, each spec
    equal to JAX's ``PartitionSpec`` entry by entry."""

    def test_tables_equal_jax(self):
        for name, rules in tsharding.STRATEGY_RULES.items():
            assert tuple(rules) == tuple(jsharding.STRATEGY_RULES[name])

    def test_fsdp_spec_mapping(self):
        assert logical_to_spec(("embed", "heads"), FSDP_RULES) == ("fsdp",)
        assert logical_to_spec(("batch", None), FSDP_RULES) == (
            ("dp", "fsdp"),)

    def test_axis_used_once(self):
        assert logical_to_spec(("embed", "embed"), FSDP_RULES) == ("fsdp",)

    def test_mesh_filtering(self):
        mesh = tmesh.build_mesh(axes={"dp": 8}, devices=RANKS)
        assert logical_to_spec(("embed", "mlp"), FSDP_RULES, mesh=mesh) == ()

    def test_merge_rules_later_wins(self):
        table = dict(merge_rules(FSDP_RULES, TP_RULES))
        assert table["mlp"] == "tp"
        assert table["batch"] == ("dp", "fsdp")

    def test_rules_for_mesh_composition(self, cpu_devices):
        jm, tm = _both(axes={"dp": 2, "fsdp": 2, "tp": 2},
                       cpu_devices=cpu_devices)
        assert rules_for_mesh(tm) == jrules(jm)
        table = dict(rules_for_mesh(tm))
        assert table["mlp"] == "tp" and table["embed"] == "fsdp"

    def test_tree_placements(self):
        from torch.distributed.tensor import Replicate, Shard

        mesh = tmesh.build_mesh(V1MeshSpec(axes={"dp": 2, "fsdp": 4}),
                                devices=RANKS)
        tree = {"w": ("embed", "mlp"), "b": ("mlp",)}
        pl = tree_placements(tree, mesh, rules_for_mesh(mesh))
        assert pl["w"] == [Replicate(), Shard(0)]
        assert pl["b"] == [Replicate(), Replicate()]

    def test_model_parallel_axes_raise(self):
        """Every pair of model-parallel axes places now (pp beside tp
        here; ``tests/test_torch_axis_pairs.py`` trains each pair): the
        layers stay whole over pp, as the reference's stored weights do,
        and tp shards ``mlp``."""
        from torch.distributed.tensor import Replicate, Shard

        mesh = tmesh.build_mesh(axes={"dp": 2, "pp": 2, "tp": 2},
                                devices=RANKS)
        pl = tree_placements({"w": ("layers", "embed", "mlp")}, mesh,
                             rules_for_mesh(mesh))
        assert pl["w"] == [Replicate(), Replicate(), Shard(2)]

    @pytest.mark.parametrize("axes", [
        {"dp": 8}, {"fsdp": 8}, {"dp": 2, "fsdp": 4}, {"dp": 2, "cp": 4},
        {"fsdp": 2, "cp": 4}, {"dp": 2, "fsdp": 2, "tp": 2},
        {"dp": 2, "ep": 4}, {"dp": 2, "pp": 2, "fsdp": 2},
        {"dp": 2, "pp": 2, "tp": 2}, {"dp": 2, "cp": 2, "tp": 2},
        {"dp": 2, "ep": 2, "tp": 2}, {"dp": 2, "fsdp": 2, "ep": 2},
    ], ids=str)
    @pytest.mark.parametrize("family", [
        "llama_tiny", "gemma_tiny", "moe_tiny", "t5_tiny", "bert_tiny",
        "vit_tiny", "mnist_cnn", "resnet_tiny", "llama_tiny+lora",
    ])
    def test_family_specs_equal_jax(self, family, axes, cpu_devices):
        """Each family's logical-axes tree equals JAX's, and so does the
        spec of every leaf under the mesh's composed rules."""
        from polyaxon_tpu.models import get_model as jget
        from polyaxon_tpu.models.lora import lora_model_def as jlora
        from polyaxon_tpu_torch.models import get_model as tget
        from polyaxon_tpu_torch.models.lora import lora_model_def as tlora

        name = family.removesuffix("+lora")
        jm_def, tm_def = jget(name), tget(name)
        if family.endswith("+lora"):
            jm_def, tm_def = jlora(jm_def, 4, 8.0), tlora(tm_def, 4, 8.0)
        jlog, tlog = jm_def.logical_axes(), tm_def.logical_axes()
        assert tlog == jlog
        jm, tm = _both(axes=axes, cpu_devices=cpu_devices)
        jr, tr = jrules(jm), rules_for_mesh(tm)
        assert tr == jr
        flat = []

        def walk(tree, path=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, f"{path}/{k}")
            else:
                flat.append((path, tree))

        walk(tlog)
        assert flat
        for path, leaf_axes in flat:
            assert tuple(logical_to_spec(leaf_axes, tr, mesh=tm)) == tuple(
                jspec(leaf_axes, jr, mesh=jm)), path


    @pytest.mark.parametrize("axes", [
        {"dp": 8}, {"fsdp": 8}, {"dp": 2, "fsdp": 4}, {"dp": 2, "cp": 4},
        {"cp": 8}, {"dp": 2, "fsdp": 2, "tp": 2},
    ], ids=str)
    def test_batch_spec_and_axes_equal_jax(self, axes, cpu_devices):
        from polyaxon_tpu.parallel.compat import batch_axes_in as jbatch_axes
        from polyaxon_tpu_torch.parallel.compat import batch_axes_in

        jm, tm = _both(axes=axes, cpu_devices=cpu_devices)
        assert batch_axes_in(tm) == jbatch_axes(jm)
        for ndim in (1, 2, 3):
            assert tuple(tsharding.batch_spec(tm, rules_for_mesh(tm),
                                              ndim=ndim)) == tuple(
                jsharding.batch_spec(jm, jrules(jm), ndim=ndim))


class TestBootstrap:
    ENV = {"POLYAXON_TPU_COORDINATOR": "10.0.0.1:8476",
           "POLYAXON_TPU_NUM_PROCESSES": "16",
           "POLYAXON_TPU_PROCESS_ID": "3"}

    @pytest.mark.parametrize("env", [ENV, {}], ids=["gang", "single"])
    def test_env_contract_equals_jax(self, env):
        want, got = jcontract(env), bootstrap.read_env_contract(env)
        assert (got.coordinator, got.num_processes, got.process_id,
                got.is_multiprocess) == (want.coordinator,
                                         want.num_processes,
                                         want.process_id,
                                         want.is_multiprocess)

    def test_missing_coordinator_raises_jax_error(self):
        group = bootstrap.read_env_contract(
            {"POLYAXON_TPU_NUM_PROCESSES": "2"})
        with pytest.raises(RuntimeError, match="COORDINATOR is unset"):
            bootstrap.initialize(group, device="cpu")
        assert not dist.is_initialized()


class TestOneRank:
    """An in-process run's group: one rank, started and destroyed."""

    def test_process_group_is_shared_then_destroyed(self):
        assert not dist.is_initialized()
        with bootstrap.process_group("cpu"):
            with bootstrap.process_group("cpu"):
                assert dist.get_world_size() == 1
            assert dist.is_initialized()
        assert not dist.is_initialized()

    def test_ring_and_ulysses_at_cp1_equal_attention(self):
        from polyaxon_tpu_torch.ops.attention import xla_attention
        from polyaxon_tpu_torch.ops.ring import ring_attention
        from polyaxon_tpu_torch.ops.ulysses import ulysses_attention

        gen = torch.Generator().manual_seed(0)
        q = torch.randn(2, 33, 4, 16, generator=gen)
        k, v = (torch.randn(2, 33, 2, 16, generator=gen) for _ in range(2))
        with bootstrap.process_group("cpu"):
            mesh = tmesh.build_mesh(axes={"dp": 1, "cp": 1})
            with tmesh.use_mesh(mesh):
                for causal in (True, False):
                    want = xla_attention(q, k, v, causal=causal)
                    # S = 33 is odd: the causal entry pads one row.
                    torch.testing.assert_close(
                        ring_attention(q, k, v, causal=causal), want,
                        atol=2e-4, rtol=2e-4)
                    torch.testing.assert_close(
                        ulysses_attention(q, k, v, causal=causal), want,
                        atol=2e-4, rtol=2e-4)

    def test_replays_equal_attention(self):
        """The zigzag schedule of cp = 2 and 4 and the Ulysses head split
        of n = 4, replayed in one process, against plain attention."""
        from polyaxon_tpu_torch.ops.attention import xla_attention
        from polyaxon_tpu_torch.ops.ring import replay_zigzag
        from polyaxon_tpu_torch.ops.ulysses import replay_ulysses

        gen = torch.Generator().manual_seed(1)
        q = torch.randn(1, 64, 8, 16, generator=gen)
        k, v = (torch.randn(1, 64, 2, 16, generator=gen) for _ in range(2))
        want = xla_attention(q, k, v, causal=True)
        for cp in (2, 4):
            torch.testing.assert_close(replay_zigzag(q, k, v, cp), want,
                                       atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(replay_ulysses(q, k, v, 4), want,
                                   atol=2e-4, rtol=2e-4)

    def test_placed_state_trains_like_plain(self):
        """A one-rank mesh: DTensor parameters, the same numbers as the
        plain step, bitwise."""
        from polyaxon_tpu_torch.models import get_model
        from polyaxon_tpu_torch.runtime.config import RuntimeConfig
        from polyaxon_tpu_torch.runtime.optim import build_optimizer
        from polyaxon_tpu_torch.runtime.step import (build_init,
                                                     build_train_step)

        model_def = get_model("llama_tiny", dtype=torch.float32)
        opt = build_optimizer(RuntimeConfig.from_dict(
            {"model": "llama_tiny", "learning_rate": 1e-3}))
        tokens = torch.randint(0, 256, (2, 32),
                               generator=torch.Generator().manual_seed(2))
        plain = build_init(model_def, opt, device="cpu")(0)
        step = build_train_step(model_def, opt)
        _, want = step(plain, {"tokens": tokens})
        with bootstrap.process_group("cpu"):
            mesh = tmesh.build_mesh(axes={"fsdp": 1})
            with tmesh.use_mesh(mesh):
                placed = build_init(model_def, opt, device="cpu", mesh=mesh,
                                    rules=rules_for_mesh(mesh))(0)
                assert all(hasattr(p, "placements") for p in
                           placed["params"]["layers"].values())
                _, got = build_train_step(model_def, opt, mesh=mesh)(
                    placed, {"tokens": tokens})
                assert float(got["loss"]) == float(want["loss"])
                assert float(got["grad_norm"]) == float(want["grad_norm"])
                w = placed["params"]["layers"]["wq"].full_tensor()
                assert torch.equal(w, plain["params"]["layers"]["wq"])

    def test_remat_recompute_sees_the_mesh_on_another_thread(self):
        """A layer recomputed under remat runs on autograd's device
        thread on the card, which does not inherit the caller's context:
        the ring must still find its mesh. Here the backward runs on a
        fresh thread."""
        import dataclasses
        import threading

        from polyaxon_tpu_torch.models import llama as tllama

        cfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"],
                                  dtype=torch.float32, remat="full",
                                  attention_impl="ring")
        params = tllama.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")["params"]
        for t in _leaves(params):
            t.requires_grad_(True)
        tokens = torch.randint(0, 256, (1, 32),
                               generator=torch.Generator().manual_seed(1))
        errors = []
        with bootstrap.process_group("cpu"):
            mesh = tmesh.build_mesh(axes={"dp": 1, "cp": 1})
            with tmesh.use_mesh(mesh):
                loss, _, _ = tllama.apply(cfg, {"params": params,
                                                "state": {}},
                                          {"tokens": tokens})

            def backward():
                try:
                    loss.backward()
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(exc)

            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
        assert not errors, errors
        assert params["layers"]["wq"].grad is not None

    def test_ring_calls_leave_no_graph_behind(self, monkeypatch):
        """Each ring call's transfers thread an ordering token; the call
        must not leave it in a reference cycle with its axis, which would
        keep the call's graph (under remat, a recomputed layer's
        activations) alive until the garbage collector runs."""
        import dataclasses
        import gc
        import weakref

        from polyaxon_tpu_torch.models import llama as tllama
        from polyaxon_tpu_torch.ops import ring

        axes = []
        init = ring._Axis.__init__

        def recording(self, *args, **kwargs):
            init(self, *args, **kwargs)
            axes.append(weakref.ref(self))

        monkeypatch.setattr(ring._Axis, "__init__", recording)
        cfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"],
                                  dtype=torch.float32, remat="full",
                                  attention_impl="ring")
        params = tllama.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")["params"]
        for t in _leaves(params):
            t.requires_grad_(True)
        tokens = torch.randint(0, 256, (1, 32),
                               generator=torch.Generator().manual_seed(1))
        gc.disable()
        try:
            with bootstrap.process_group("cpu"):
                mesh = tmesh.build_mesh(axes={"dp": 1, "cp": 1})
                with tmesh.use_mesh(mesh):
                    loss, _, _ = tllama.apply(
                        cfg, {"params": params, "state": {}},
                        {"tokens": tokens})
                loss.backward()
                del loss
            # The forward's calls and the recompute's, one per layer each.
            assert len(axes) == 2 * cfg.n_layers
            assert all(a() is None for a in axes)
        finally:
            gc.enable()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
