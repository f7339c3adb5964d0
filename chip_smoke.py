#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``polyaxon_tpu_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which must pass:

1. Build every kernel of the serving and training paths from
   ``ops/csrc`` with nvcc (all builds in parallel) and hold each kernel
   against its plain PyTorch version at the paths' shapes: the flash
   forward at llama3_8b prefill (a ragged length and 2048), at the
   llama3_1b training microbatch (B=4, S=4096, D=64, packed segments) and
   at gemma_2b's (S=4096, D=256, MQA 8:1, causal and with a window); paged
   decode at five cases (``decode_cases``: llama3_8b at 8 ragged rows
   with a hole and an idle row, at 8 long rows, gemma_2b's MQA, llama3_1b
   at 64 rows, moe_8x200m's 16:8 heads at head_dim 64 up to 2,048
   positions; one split and several must both be held, two calls must
   agree bitwise), timed by CUDA-graph replay with a cold L2, and two
   streams launching multi-split decode at once, in a loop (each must
   match the plain version); the flash backward pair at llama3_1b's packed training microbatch (B=4,
   the dK/dV kernel's in-block group loop, as training runs it), at the
   same row alone (B=1), at gemma_2b's packed shape and at a ragged length
   with GQA 4:1 at head_dim 128 (these three through its head-split grid;
   each case prints its split count, and both grids must be held). Times
   each kernel, its plain version
   and, where one PyTorch call computes the same function,
   ``F.scaled_dot_product_attention`` (forward or backward) as a
   yardstick the port never calls; the backward pair also with the
   training path's packed segments. Then the forward and the backward
   pair at the shapes phases 11-13 give them (PATH_CASES, D=64): t5's
   encoder without a causal mask at t5_base's training microbatch (B=32,
   S=512, 12:12 heads) and a served encoder length of 300, t5's decoder
   self-attention (causal) at that microbatch, and moe_8x200m's training
   microbatch (B=4, S=2048, 16:8 heads, causal), held and timed beside
   SDPA, the bounds counting the visible pairs (all S^2 without a
   causal mask).
2. The serving path: ``ContinuousBatchingEngine`` over llama3_8b at full
   width and depth (random bf16 weights from a seed), 16 requests of
   mixed lengths, some sharing a prefix. The kernels' launch counts are
   zeroed just before and read just after; both must have moved, and the
   page pool's invariants must hold. The first admission's prefill KV
   and first decode logits are then held against the plain path.
   Then the rest of serving, at full width and depth over the same
   weights (then mistral_7b's and llama3_1b's), each with its launches:

   a. The dense engine (``kv="dense"``) serves the 16-request mix and the
      static ``_Engine`` 4 of its prompts; the dense first admission's
      logits are held against the paged path's and the dense plain path's
      (einsum prefill), and chunked prefill (512) of the 2,047-token
      prompt against the unchunked prefill (MODEL_REL_TOL); the chunked
      engine then serves it.
   c. Speculation: llama3_draft_200m drafts k=4 for llama3_8b, greedy,
      through the dense engine and the static engine; each row equals the
      plain dense engine's tokens, or first diverges at a near-tie
      (NEAR_TIE_ULPS), and every emitted token is the target's greedy
      choice given its own prefix up to a near-tie (as are the dense and
      static engines' rows); the acceptance rate is printed. Then
      llama3_8b drafts for itself through both engines under the same
      rule: with random weights the small draft's proposals are all
      rejected, while a self-draft's must be accepted (rate > 0.5), so
      the accepted-token path runs at full width.
   e. Prefill lanes (2 rows, 256-token chunks), request classes and
      preemption on the paged engine with KV pages for four long requests
      (no request needs a page after admission, see LANE_PROMPT):
      a burst of long best-effort requests (the preemptible class) and two
      batch ones, then interactive ones; handoffs and preemptions must
      fire, every request finish, the invariants hold, and the preempted
      request's tokens equal its solo run's (near-tie rule); TTFT per
      class from the request timelines.
   f. ``ServingServer("llama3_8b")`` with no engine arguments serves the
      static engine; a streamed answer equals the non-streamed one; with
      ``batching="continuous"`` over a dense cache its
      ``/requests/<id>/timeline`` has the reference's span names.
   d. int8: the weights quantized (bytes before and after), the paged
      engine serves the mix, the first admission's logits are held
      against bf16's (INT8_REL_TOL), and the decode-step time printed
      beside phase 2's.
   b. mistral_7b: a 4,000-token prompt and 256 new tokens over its
      4,096-slot ring (it wraps); the last decode step's logits against
      one windowed forward over the 4,256 tokens (MODEL_REL_TOL), and the
      dense engine serving the same request.
   g. A ``ServingFleet`` of two llama3_1b replicas: 16 requests, 8 sharing
      a 256-token prefix; the shared ones land on one replica, both
      replicas serve, and ``/v1/fleet`` has both replicas' series.
3. ``ServingServer`` answers two concurrent ``POST /v1/generate``.
4. The training path: ``run_torchjob`` trains llama3_1b at full width
   and depth (f32 master weights from a seed, bf16 compute) on packed
   4096-token rows, global batch 16 in 4 microbatches, remat "dots",
   flash attention, adamw with a cosine schedule, for 6 steps. The three
   flash counters are zeroed just before and read just after: each
   backward kernel must run once per layer and microbatch, and every
   loss and gradient norm must be finite.
5. First-step parity: one packed 1x4096 microbatch through the kernel
   path (remat "none" and "dots") and the plain path (einsum attention)
   from the same weights; the loss and three named gradients must agree.
   Each backward call of a kernel run must agree, on its own inputs, with
   the plain backward that rounds P and dS to bf16 as the kernels do, and
   the kernel path's gradients with those of the forward kernel and the
   f32 plain backward.
6. The training path at head_dim 256: ``run_torchjob`` trains gemma_2b at
   full width and depth (18 layers, MQA 8:1, 2.51 B parameters) on packed
   4096-token rows, global batch 4 in 4 microbatches, for 3 steps, with
   the counters checked as in phase 4.
7. The checkpoint drill: phase 4's job with checkpoints every 2 steps
   (one kept, saved asynchronously), launched as
   ``python -m polyaxon_tpu_torch.runtime.launch`` in a temporary
   artifacts directory and SIGKILLed as soon as the store lists a
   committed step, then started again on the same directory: it must
   restore that step from the spill or the store, reach step 6 and exit
   0, with each backward kernel launched once per layer, microbatch and
   step it trained. Its losses are held against an uninterrupted run at
   its depth (phase 4's at full depth; bitwise if a second uninterrupted
   run repeats the first bitwise, else within three times the two runs'
   spread), the tracking record is read back (loss
   events, outputs, statuses, GPU memory samples), the checkpoint is
   restored here and its leaf CRC-32s held against the manifest, and
   tier 0 is timed here (the replica a spill restore promotes, then a
   snapshot published as the replica), with no further disk write. The
   drill's files go to a fresh temporary directory; its depth is cut to
   DRILL_LAYERS (4 of 16) for phase 20's time, and further only if three
   checkpoints do not fit in the free disk or in DRILL_DISK_BUDGET, or
   the launcher's snapshot in host memory.
8. The paged engine serves the drill's checkpoint: two requests of 16
   new tokens (flash forward and paged decode at head_dim 64, counters
   zeroed before and read after), then the first admission against the
   plain path.
9. Polyaxonfile through the plane and the agent:
   ``examples/packed_pretrain.yaml``, as it is, submitted to the port's
   ``ControlPlane`` in a fresh temporary home with the gpu preset and
   H100_PRESET (one process, phase 4's steps and microbatches) on a
   synthetic text corpus from SEED (``lm_text_packed``, the bytes
   tokenizer). The port's ``Agent`` compiles it, starts it as a
   subprocess gang (the plan's one process, the port's launcher, after
   the plan's ``auth`` init phase) and drives it to SUCCEEDED. The
   record's status history must be SUBPROCESS_HISTORY, each hop legal;
   ``plane.streams`` must return a finite loss per trained step, 6 steps
   in the outputs and a ``checkpoints`` artifact; ``<artifacts>/.auth``
   must exist; the trace must hold the gang's ``execute`` span with the
   launcher's ``runtime`` span under it and its spans under that; the
   committed step 6 is restored here and held against the manifest's
   CRC-32s; the launcher's log ends with its kernel launches: each
   backward kernel once per layer, microbatch and step, the forward
   twice as often. Prints submit to compiled, the compile span, queued to
   the process's start, the process's wall, submit to SUCCEEDED and the
   plane's overhead (the last less the process), and tokens/s and MFU
   beside phase 4's. The depth is cut to PLAN_LAYERS (8 of 16) for phase
   20's time, and further only if one checkpoint does not fit, by the
   drill's rule.
10. The acceptance sweep on the card: SWEEP, a copy of
   ``tests/test_acceptance.py``'s HYPERBAND_SWEEP whose trials are
   llama_200m at full width and depth (flash attention, seq 2048, global
   batch 8, one device) with one checkpoint each, run by
   ``Agent(plane, max_concurrent=2, in_process=True)`` in a fresh
   temporary directory (phase 9's removed) to SUCCEEDED. The acceptance
   test's asserts must hold (at least 3 trials, a promoted rung, more
   steps at the top rung); each trial's losses must be finite and each
   flash kernel must launch layers x steps times summed over the trials.
   The best trial's checkpoint is then served by ``ServingServer``: one
   ``POST /v1/generate`` of 5 tokens, the forward and paged-decode
   counters moving. The depth is cut only if every trial's checkpoint
   does not fit in DRILL_DISK_BUDGET, or its tier-0 replica in host
   memory (a cut is printed).

11. MoE training: ``examples/moe_expert_parallel.yaml`` compiled by the
   port with the gpu preset (one device for its dp2 x ep8 mesh: this
   machine has one H100) and run by the port's launcher in
   this process: moe_8x200m at full width and depth, lm_synthetic, seq
   2048, global batch 32 in MOE_ACCUM microbatches, ragged dispatch,
   MOE_STEPS steps; losses and router_aux finite, each flash kernel once
   per layer and microbatch, tokens/s and MFU from the active parameters.
   Then its first-step parity (``moe_parity``), each compared run
   replaying the kernel path's routing (``_Routing``), within phase 5's
   tolerances (the loss; layer 0's router, w_gate and wq gradients): the
   kernel path against the plain path at no-drop capacity and at the
   training capacity, ragged against dense dispatch at no-drop capacity,
   and phase 5's backward witnesses.
12. MoE serving: moe_8x200m (bf16) on the dense and the paged engines
   over phase 2's mix (each prompt cut to leave room for 32 new tokens in
   2,048 positions) at no-drop capacity, radix hits required, each
   engine's routing recorded per row and position (``_EngineRoutes``):
   every token of both engines' rows must be the target's argmax given
   its own prefix up to a near-tie, the teacher replaying that engine's
   routing, and where two rows part, the engines' routings must differ
   in their common prefix or the parting sit at a near-tie
   (``moe_rows_check``); the mix at the default capacity on the paged engine, its
   token streams printed, not held (ROADMAP Queue 3); then mixtral_8x7b
   at full width and MIXTRAL_LAYERS of its 32 layers on the paged engine
   (MIXTRAL_PROMPTS, 32 new tokens), its first admission held against
   the plain path replaying the kernel path's routing.
13. T5: ``examples/t5_seq2seq.yaml`` compiled and run by the launcher
   (t5_base, seq2seq_synthetic, adafactor, seq 512, global batch 64 in
   T5_ACCUM microbatches, remat dots, T5_STEPS steps; one device for its
   dp2 mesh): the forward kernel's calls split by the causal flag (the
   encoder's non-causal, the decoder's causal), each backward once per
   attention layer and microbatch. Then ``ServingServer("t5_base")`` on
   its defaults answers one request, streamed equal to non-streamed; the
   continuous engine serves T5_PROMPTS; the first admission's decoder
   logits are held against the plain path.
14. The other families, a few steps each at full width and depth with
   finite losses and no kernel launched: bert_large (mlm_synthetic, seq
   512, lion), vit_b16 (``examples/hyperband_vit.yaml`` at one trial's
   values), resnet50 (imagenet_synthetic, batch 64; its batch statistics
   must move) and mnist_cnn (``examples/mnist.yaml``).
15. LoRA: ``examples/lora_finetune.yaml``'s runtime, llama3_8b at full
   width, rank 16, alpha 32, seq 4096, LORA_STEPS steps of LORA_BATCH
   rows in microbatches of 1, one checkpoint, the depth cut to
   LORA_LAYERS (4 of 32) by ``lora_depth`` for phase 20's time: each
   backward kernel once per layer and microbatch, optimizer state for the adapters alone, the base equal to its seeded
   init, every B moved. ``ServingServer("llama3_8b", checkpoint=...)``
   then merges the adapters from the checkpoint's ``_meta``, answers one
   request, and its first admission is held against the plain path.

16. Telemetry and chaos (lines ``16a.`` to ``16c.``). (a) In a fresh
   temporary directory a ``TieredCheckpointManager`` saves two steps of
   llama3_1b's full-width f32 params on the card; a restore with
   ``checkpoint/corrupt_latest`` installed must return the older step
   from tier 1 or 2 with the newer skipped, and one with
   ``tier0-loss/drop`` installed must come from the store; each restore's
   leaves are held against that step's manifest CRC-32s, each must add
   one sample to ``polyaxon_checkpoint_restore_seconds{tier}``, and the
   history ring must hold the closed ``chaos.checkpoint`` window. (b)
   Phase 9's run, once SUCCEEDED: the process's metrics registry, its
   history ring and the default alert engine are reset before the run
   is submitted, so what is judged is that run's own telemetry.
   ``plane.report`` must close its phase accounting within
   ``phase-accounting-closes``' tolerance, and ``plane.verify`` must
   return a verdict for each of the 16 invariants, with
   ``all-runs-terminal``, ``phase-accounting-closes``,
   ``loss-continuity`` and ``zero-unresolved-alerts`` passing; the agent
   must have run its history and alert passes. After phase 10's sweep, ``plane.verify()`` across its
   whole plane is printed. (c) Phase f's server must answer ``GET
   /alerts`` with 200 and the 18 committed rules; phase g's fleet calls
   ``maybe_scale`` with the firing rule ids of an alert engine over its
   registry. Prints the restore seconds by tier, the report's phases and
   step trend, every verdict, the passes' counts and times, and the time
   of ``report``, ``verify``, an alert pass and a history sample.
17. Data and context parallelism (lines ``17a.`` to ``17d.``). (a)
   ``examples/longcontext_ring.yaml`` compiled by the port with the gpu
   preset (one device for its dp2 x cp8 mesh; global batch 16 cut to 1,
   1,000 steps to LONGCTX_STEPS) and run by the port's launcher with a
   one-process bootstrap env: a real one-rank NCCL group, the parameters
   DTensors on a one-device mesh; llama3_1b at full width and depth,
   32,768 tokens, ring attention, remat full. The flash kernels must
   launch 6 forward and 3 of each backward per layer and step, and the
   launcher must leave no process group behind. (b) One 32,768-token row
   through ``attention_impl="ring"`` against ``"flash"``: the loss and
   every leaf's gradient within phase 5's tolerances. (c) The zigzag's
   schedule at cp = 2, 4 and 8 and (d) Ulysses' n = 4 head split,
   replayed in one process through the kernels at that row, forward and
   backward, against ``flash_attention`` on the whole row (and at
   RING_PLAIN_SEQ against the plain versions); 17d also calls
   ``dot_product_attention(impl="ulysses")`` on a one-rank mesh, which
   must launch the flash kernel. Phase 1 also holds the
   kernels at the ring's block shapes (``PATH_CASES``).
18. Tensor, expert and pipeline parallelism (lines ``18a.`` to
   ``18d.``), replayed in this process (this machine has one H100):
   (a) llama3_8b at full width and depth (random bf16 weights) on one
   4,096-token row split tp = 2, 4 and 8 ways: each rank's
   vocab-parallel embedding, column-parallel projections, local heads
   through the flash kernels (8:2 at tp4) and row-parallel partials,
   summed in place of the all-reduce, and the vocab-parallel cross
   entropy, against the unsplit model (phase 5's tolerances); (b)
   moe_8x200m's training microbatch (4 x 2,048 tokens) through the ragged
   dispatch at ep = 2, 4 and 8, every rank's send buffers built here and
   each all-to-all done as its transpose, forward and backward against
   ep = 1 at no-drop capacity (phase 11's routing replay), and the drops
   per ep at the default capacity; (c) llama3_1b's layers as a 4-stage
   GPipe schedule of 4 microbatches of one 4,096-token row, single- and
   double-buffered, against the unpipelined layers, the two schedules'
   outputs equal bit for bit; (d) ``examples/longcontext_ring.yaml``
   compiled with a {dp: 1, tp: 1, pp: 1, ep: 1} mesh and
   ``pipeline_stages: 1`` and run by the launcher on a one-rank NCCL
   group (no collective runs) for 2 steps, no group left behind. Phase 1
   also holds the kernels at the tp-local shapes (``PATH_CASES``:
   llama3_8b and llama3_1b at tp4, 8:2 heads).

19. Sharded serving (``19a.`` lines): llama3_8b at full width and
   depth (random bf16 weights) served at tp2 by ``ServingServer(
   mesh_axes={"tp": 2})``'s gang engine, two processes sharing the card
   over a gloo group (``scripts/probe_gloo_cuda.py``: gloo carries the
   gang's collectives of CUDA tensors; NCCL refuses two ranks on one
   device), the paged continuous engine on the mix's first eight
   prompts: the prefill's and 8 decode steps' logits against the
   unsharded model's, the tokens against the unsharded paged engine's
   on every row clear of near-ties, tokens/s, the median decode step
   and each rank's peak memory. Phase 1 also holds the kernels at the
   tp-local serving shapes (``PATH_CASES``: the 2,048-token prefill at
   16:4 heads; ``decode_cases``: 8 ragged rows at 16:4 and 8:2).

20. An elastic gang (``20. elastic`` lines): ``ELASTIC_SPEC``
   (llama3_1b at full width, cut to ELASTIC_LAYERS = 2 of 16 layers,
   adafactor, dp2, checkpoints every 2 steps that restore on start)
   submitted to the port's plane and run by ``Agent(plane,
   in_process=True, local_devices=[0, 0])``: two local devices sharing
   the card, each rank re-running this script as ``--train-rank``
   (gloo; NCCL refuses two ranks on one device). First unresized with
   checkpointing off; then with chaos ``slice-loss`` kill after the
   first checkpoint and restore after the third, so the run trains
   dp2 → dp1 (in the agent's thread) → dp2, with the inline prewarm.
   The run must reach SUCCEEDED with no retry, the two resizes in
   ``meta["elastic"]``, three segments, ``loss-continuity`` passing and
   every emitted loss within TRAIN_LOSS_REL_TOL of the unresized run's;
   the training kernels must launch in the ranks and in the thread.
   Prints each segment's step ms and restore (seconds, tier), each
   resize's forced save, prewarm, relaunch and restore seconds, the
   gangs' stop agreement per step, ``meta["elastic"]`` and
   ``meta["checkpoint"]``.

21. The axis pairs (``21a.`` and ``21b.`` lines). (a) The new pairs'
   rank programs replayed in this process at full width, forward and
   backward through the flash kernels, each against the unsplit step
   (phase 18's tolerances): llama3_8b, cut to PAIR_LAYERS of its 32
   layers, at pp2 x tp2 (a 2-stage GPipe schedule of two 4,096-token
   microbatches whose stages run each tp rank's blocks) and at tp2 x cp2
   (one 4,096-token row, each tp rank's heads through the zigzag ring of
   two cp ranks), with the vocab-parallel embedding and cross entropy;
   moe_8x200m at full width and depth at tp2 x ep2 (each tp rank's heads,
   and the ragged dispatch at ep2 through each tp rank's share of every
   expert's mlp), at no-drop capacity with the unsplit run's routing
   replayed. (b) moe_8x200m served at ep2 by two processes sharing the
   card over gloo (each rank 4 of the 8 experts; decode through the
   dense dispatch), the paged engine on the mix's first eight prompts,
   every row held by phase 12's rule (``moe_rows_check``) against the
   unsharded paged engine with each engine's routing replayed. Phase 1
   also holds the kernels at the pairs' shapes (``PATH_CASES``: 16:4
   heads at D=128 over a 4,096-token row, and a tp rank's zigzag blocks,
   16:4 at 2,048 rows, causal and not).

Prints the card, the toolchain, per-phase lines, then a ``kernels`` JSON
line, the ``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
without a GPU or outside a checkout.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

SEED = 0
# Tolerances, stated once. bf16 outputs carry 2^-8 relative rounding
# (one ulp is 1.6e-2 at |o| in [2, 4), where an early causal row that
# sees few keys can sit); the kernels also round P to bf16 for the
# tensor-core P@V product and sum in another order than the plain
# versions (which compute in f32 from the same bf16 inputs). So outputs
# pass at |kernel - plain| <= ATOL + RTOL * |plain|: about two ulps.
OUT_ATOL = 1e-2
OUT_RTOL = 1e-2
FLASH_LSE_ATOL = 2e-3    # f32 lse; only the product order differs
# Model-level: 32 bf16 layers amplify those roundings; relative to the
# largest reference magnitude.
MODEL_REL_TOL = 5e-2
# Backward kernels: gradients are sums of up to S * n_rep bf16-rounded
# products (P and dS are rounded to bf16 for the tensor cores), so the
# absolute tolerance is relative to the largest reference value:
# |kernel - plain| <= BWD_ATOL_REL * max|plain| + BWD_RTOL * |plain|.
BWD_ATOL_REL = 1e-2
BWD_RTOL = 2e-2
# Training parity through 16 bf16 layers, kernel path against the plain
# path: the loss to TRAIN_LOSS_REL_TOL relative, each named gradient to
# TRAIN_GRAD_REL_TOL in relative Frobenius norm (|a - b| / |b|).
# The readings on an H100 (PERF.md): loss 7.7e-6; gradients 2.3e-2, all
# but 1e-4 of it also there with the forward kernel and the f32 plain
# backward, i.e. from the forward's roundings (the plain path rounds its
# logits to bf16) amplified through 16 bf16 layers. The gradient
# tolerance is 1.5x its reading.
TRAIN_LOSS_REL_TOL = 5e-3
TRAIN_GRAD_REL_TOL = 3.5e-2
# The backward kernels alone, 1.5x their readings: the kernel path
# against the forward kernel with the f32 plain backward (read 1.35e-2 at
# layer 0, as much as rounding P and dS to bf16 in the plain backward
# moves it: 1.34e-2), and each layer's backward call against
# ``flash_bwd_plain_bf16`` on the same inputs, as max|err| / max|plain|
# (read at most 5.2e-3; the tolerance is one bf16 ulp at the largest
# value).
TRAIN_BWD_REL_TOL = 2e-2
TRAIN_LAYER_BWD_TOL = 2.0 ** -7

# The training main path, modeled on examples/packed_pretrain.yaml (see
# PERF.md section 4 for the two cuts: synthetic packed data, and the
# global batch of 16 taken in 4 microbatches to fit one card).
TRAIN_LAYERS = 16
TRAIN_STEPS = 6
TRAIN_ACCUM = 4
TRAIN_JOB = {
    "kind": "jaxjob",
    "mesh": {"axes": {"fsdp": -1}},
    "checkpointing": {"enabled": False},
    "runtime": {
        "model": "llama3_1b", "dataset": "lm_packed_synthetic",
        "steps": TRAIN_STEPS, "seq_len": 4096, "global_batch_size": 16,
        "grad_accum_steps": TRAIN_ACCUM, "learning_rate": 3e-4,
        "lr_schedule": "cosine", "optimizer": "adamw", "remat": "dots",
        "attention_impl": "flash", "log_every": 1, "seed": SEED,
    },
}
# gemma_2b at full width and depth (head_dim 256, MQA 8:1, 2.51 B
# parameters), the same recipe at global batch 4 in 4 microbatches of 1
# (PERF.md section 4), for 3 steps.
GEMMA_LAYERS = 18
GEMMA_STEPS = 3
GEMMA_ACCUM = 4
GEMMA_JOB = {
    "kind": "jaxjob",
    "mesh": {"axes": {"fsdp": -1}},
    "checkpointing": {"enabled": False},
    "runtime": {
        "model": "gemma_2b", "dataset": "lm_packed_synthetic",
        "steps": GEMMA_STEPS, "seq_len": 4096, "global_batch_size": 4,
        "grad_accum_steps": GEMMA_ACCUM, "learning_rate": 3e-4,
        "lr_schedule": "cosine", "optimizer": "adamw", "remat": "dots",
        "attention_impl": "flash", "log_every": 1, "seed": SEED,
    },
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def card_peaks(name: str) -> tuple[float, float, str]:
    """(dense bf16 FLOP/s, HBM bytes/s, label) of the card, from
    NVIDIA's data sheets (SXM parts; PCIe and NVL parts have their own)."""
    if "H200" in name:
        return 989e12, 4.8e12, "H200 SXM"
    if "PCIe" in name:
        return 756e12, 2.0e12, "H100 PCIe"
    if "NVL" in name:
        return 835e12, 3.9e12, "H100 NVL"
    return 989e12, 3.35e12, "H100 SXM"


def close(got, want) -> bool:
    import torch

    return torch.allclose(got.float(), want.float(), atol=OUT_ATOL,
                          rtol=OUT_RTOL)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------ kernels
def check_flash(torch, flash, peaks, gen):
    """Kernel vs plain at the paths' shapes: llama3_8b prefill (S=1000 and
    S=2048, D=128; the kernels line's record is S=2048), the llama3_1b
    training microbatch (D=64, held with packed segments, timed without)
    and gemma_2b's (D=256, MQA 8:1, causal and with a 1024 window). Each
    timed case prints kernel, plain, SDPA and bound ms and TFLOP/s."""
    from polyaxon_tpu_torch.runtime.data import lm_packed_synthetic

    worst = 0.0
    rec = None
    for S in (1000, 2048):
        args = _flash_inputs(torch, gen, 1, S, 32, 8, 128)
        worst = max(worst, hold_flash(torch, flash, f"llama3_8b S={S}",
                                      *args))
        rec = time_flash(torch, flash, peaks, f"llama3_8b S={S}", *args)
        del args
    rec["max_abs_err"] = worst

    segs = torch.from_numpy(next(lm_packed_synthetic(
        4, seq_len=4096, vocab_size=128_256, seed=SEED))["segments"]).cuda()
    args = _flash_inputs(torch, gen, 4, 4096, 32, 8, 64)
    rec["max_abs_err"] = max(rec["max_abs_err"], hold_flash(
        torch, flash, "llama3_1b B=4 S=4096 D=64 packed", *args, seg=segs))
    time_flash(torch, flash, peaks, "llama3_1b B=4 S=4096 D=64", *args)
    del args
    args = _flash_inputs(torch, gen, 1, 4096, 8, 1, 256)
    for window in (None, 1024):
        label = f"gemma_2b S=4096 D=256 window={window}"
        rec["max_abs_err"] = max(rec["max_abs_err"], hold_flash(
            torch, flash, label, *args, window=window))
        time_flash(torch, flash, peaks, label, *args, window=window)
    del args
    torch.cuda.empty_cache()
    return rec


def _flash_inputs(torch, gen, B, S, H, KV, D):
    return tuple(torch.randn(B, S, n, D, generator=gen, device="cuda",
                             dtype=torch.bfloat16) for n in (H, KV, KV))


def hold_flash(torch, flash, label, q, k, v, *, seg=None, window=None,
               causal=True, heads=None):
    """The forward kernel against ``flash_fwd_plain`` (on the first
    ``heads`` query heads and their KV heads when given); fails on a
    disagreement, returns the max abs error of o."""
    D, H, KV = q.shape[-1], q.shape[2], k.shape[2]
    o, lse = flash.flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window, segment_ids=seg)
    torch.cuda.synchronize()
    h = heads or H
    kvh = h * KV // H
    o, lse = o[:, :, :h], lse[:, :h]
    po, plse = flash.flash_fwd_plain(q[:, :, :h], k[:, :, :kvh],
                                     v[:, :, :kvh], causal=causal,
                                     scale=D ** -0.5, window=window,
                                     segment_ids=seg)
    torch.cuda.synchronize()
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        fail(f"flash kernel produced non-finite values ({label})")
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    if not close(o, po) or err_lse > FLASH_LSE_ATOL:
        fail(f"flash kernel disagrees with its plain version ({label}): "
             f"o max abs err {err_o} (atol {OUT_ATOL} + rtol {OUT_RTOL}), "
             f"lse err {err_lse} (tol {FLASH_LSE_ATOL})")
    held = f" (first {h} of {H} heads)" if h < H else ""
    print(f"flash {label}{' packed' if seg is not None else ''}: "
          f"max_abs_err o={err_o:.3e} lse={err_lse:.3e}{held}", flush=True)
    del o, lse, po, plse
    torch.cuda.empty_cache()
    return err_o


def time_flash(torch, flash, peaks, label, q, k, v, *, window=None,
               causal=True, heads=None):
    """Kernel, plain and (without a window) SDPA times of the forward,
    and its bound; returns the record. With ``heads``, the plain version
    runs on that many query heads and its time is scaled to all."""
    import torch.nn.functional as F

    B, S, H, D = q.shape
    KV = k.shape[2]
    h = heads or H
    kvh = h * KV // H
    ms = time_ms(lambda: flash.flash_attention_with_lse(
        q, k, v, causal=causal, window=window), reps=20)
    plain_ms = time_ms(lambda: flash.flash_fwd_plain(
        q[:, :, :h], k[:, :, :kvh], v[:, :, :kvh], causal=causal,
        scale=D ** -0.5, window=window), reps=3, warmup=1) * H / h
    lib_ms = None
    if window is None:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps=20)
        del qt, kt, vt
    # Visible (row, col) pairs: the causal triangle, cut to the band; all
    # S^2 of them without a causal mask.
    pairs = (sum(min(r + 1, window or r + 1) for r in range(S)) if causal
             else S * S)
    flops = 4.0 * B * H * pairs * D
    nbytes = (2.0 * (2 * B * S * H * D + 2 * B * S * KV * D)
              + 4.0 * B * H * S)  # q, k, v read; o, lse written
    bound_ms = max(flops / peaks[0], nbytes / peaks[1]) * 1e3
    by = "operations" if flops / peaks[0] >= nbytes / peaks[1] else "bytes"
    lib = f"{lib_ms:.4f}" if lib_ms is not None else "none"
    scaled = f" ({H // h} x {h} heads)" if h < H else ""
    print(f"flash {label} B={B} H={H} KV={KV}: kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}{scaled} sdpa_ms={lib} "
          f"bound_ms={bound_ms:.4f} "
          f"({by}) kernel_TFLOPs={flops / ms / 1e9:.1f}", flush=True)
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms}


# Paged decode cases (label, B, H, KV, Hd, page, maxp, positions, holes as
# (row, table slot)): a. llama3_8b at 8 rows, ragged up to 2,047, a hole
# and an idle row (the kernels line's record); b. llama3_8b at 8 long
# rows (6,000 to 8,191); c. gemma_2b's MQA (8 q heads on 1 kv head,
# head_dim 256), ragged up to 8,191; d. llama3_1b at 64 rows, positions
# seeded uniform in 0..2,047 (a grid that fills the card: one split);
# e. moe_8x200m's 16:8 heads, head_dim 64, ragged up to its 2,048
# positions, with a hole and an idle row; f. and g. case a's rows at a
# tp rank's heads, 16:4 at tp2 (phase 19) and 8:2 at tp4 (llama3_8b and
# mixtral_8x7b on four cards).
def decode_cases():
    import numpy as np

    d_pos = np.random.default_rng(SEED).integers(0, 2048, 64).tolist()
    return (
        ("a llama3_8b B=8", 8, 32, 8, 128, 16, 128,
         [2047, 1000, 517, 1533, 64, 1999, 1200, -1], [(1, 20)]),
        ("b llama3_8b long B=8", 8, 32, 8, 128, 16, 512,
         [8191, 6000, 7013, 6544, 8000, 6321, 7777, 7400], [(2, 100)]),
        ("c gemma_2b B=8", 8, 8, 1, 256, 16, 512,
         [8191, 4000, 1033, 6133, 257, 7999, 4800, -1], []),
        ("d llama3_1b B=64", 64, 32, 8, 64, 16, 128, d_pos, []),
        ("e moe_8x200m B=8", 8, 16, 8, 64, 16, 128,
         [2047, 1500, 1015, 700, 300, 129, 37, -1], [(3, 10)]),
        ("f llama3_8b tp2 B=8", 8, 16, 4, 128, 16, 128,
         [2047, 1000, 517, 1533, 64, 1999, 1200, -1], [(1, 20)]),
        ("g llama3_8b/mixtral_8x7b tp4 B=8", 8, 8, 2, 128, 16, 128,
         [2047, 1000, 517, 1533, 64, 1999, 1200, -1], [(1, 20)]),
    )


# Enough copies of (q, K pool, V pool) that one graph replay touches four
# times the 50 MB L2 between two uses of a copy: every launch reads its
# K/V from HBM, as the engine's decode step does (a whole model's weights
# stream between two calls of one layer).
COLD_BYTES = 200e6


def decode_case(torch, gen, label, B, H, KV, Hd, page, maxp, pos, holes):
    """Tables over a pool of just the live pages (a seeded permutation),
    the holes punched, and as many input copies as ``COLD_BYTES`` needs.
    Also the bytes and operations of the bound."""
    pos_t = torch.tensor(pos, dtype=torch.int32)
    pages = [p // page + 1 if p >= 0 else 0 for p in pos]
    P = sum(pages) + 1
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    tables = torch.full((B, maxp), -1, dtype=torch.int32)
    used = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    for b, j in holes:
        tables[b, j] = -1
    # Bytes this run's data needs: each visible K/V token row once (holes
    # and columns past pos excluded), q, tables and pos read, out written.
    live = 0
    for b, p in enumerate(pos):
        for j in range(pages[b]):
            if int(tables[b, j]) >= 0:
                live += min(page, p - j * page + 1)
    kv_bytes = 2.0 * live * KV * Hd * 2
    copies = max(2, math.ceil(COLD_BYTES / kv_bytes))
    ins = [tuple(torch.randn(*shape, generator=gen, device="cuda",
                             dtype=torch.bfloat16)
                 for shape in ((B, H, Hd), (P, page, KV, Hd),
                               (P, page, KV, Hd)))
           for _ in range(copies)]
    return {"label": label, "shape": (B, H, KV, Hd, page, maxp),
            "ins": ins, "tables": tables.cuda(), "pos": pos_t.cuda(),
            "live_tokens": live,
            "bytes": kv_bytes + 2.0 * 2 * B * H * Hd + 4.0 * B * (maxp + 1),
            "flops": 4.0 * live * H * Hd}


def time_decode(torch, paged, case, reps: int = 20):
    """(graph ms, eager ms) of the wrapper at one case. Graph: ``reps``
    launches captured in one CUDA graph, rotating through the case's
    input copies (cold L2), timed over 3 replays by CUDA events. Eager:
    50 launches from Python on one copy (warm L2), the host-bound way the
    engine calls it today."""
    tables, pos = case["tables"], case["pos"]
    fns = [lambda c=c: paged.paged_decode_attention(*c, tables, pos)
           for c in case["ins"]]
    # Warm up on the capture stream, so its merge-counter buffer exists
    # before the capture and the graph holds kernel launches only.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph_ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return graph_ms, time_ms(fns[0], reps=50)


def check_paged(torch, paged, peaks, gen):
    """The decode kernel against ``paged_decode_plain`` at the four
    ``decode_cases``: finite, within OUT_ATOL/OUT_RTOL, idle rows exactly
    zero, two calls bitwise equal; one case with one split and one with
    more must be held. Each case prints its split count, the graph (cold
    L2) and eager times, the bound and the achieved GB/s. Returns case
    a's record, with the worst error over the cases."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, rec, kinds = 0.0, None, set()
    for spec in decode_cases():
        case = decode_case(torch, gen, *spec)
        label, (B, H, KV, Hd, page, maxp) = case["label"], case["shape"]
        tables, pos = case["tables"], case["pos"]
        q, kp, vp = case["ins"][0]
        splits = paged.decode_splits(B, H, KV, page, maxp, sms)
        out = paged.paged_decode_attention(q, kp, vp, tables, pos)
        again = paged.paged_decode_attention(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        ref = paged.paged_decode_plain(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"paged decode kernel produced non-finite values ({label})")
        idle = (pos < 0).nonzero().flatten().tolist()
        if idle and out[idle].abs().max().item() != 0.0:
            fail(f"paged decode kernel: idle row is not zero ({label})")
        if not torch.equal(out, again):
            fail(f"paged decode kernel: two calls differ ({label})")
        err = (out.float() - ref.float()).abs().max().item()
        if not close(out, ref):
            fail(f"paged decode kernel disagrees with its plain version "
                 f"({label}): max abs err {err} (atol {OUT_ATOL} + rtol "
                 f"{OUT_RTOL})")
        worst = max(worst, err)
        kinds.add(splits > 1)
        del out, again, ref
        ms, eager_ms = time_decode(torch, paged, case)
        t_ops, t_bytes = case["flops"] / peaks[0], case["bytes"] / peaks[1]
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"paged_decode {label} H={H} KV={KV} Hd={Hd} maxp={maxp}: "
              f"splits={splits} max_abs_err={err:.3e} kernel_ms={ms:.4f} "
              f"(graph, cold L2, {len(case['ins'])} input copies) "
              f"eager_ms={eager_ms:.4f} (50 host-issued launches, warm L2) "
              f"bound_ms={bound_ms:.4f} ({by}) live_tokens="
              f"{case['live_tokens']} bytes={case['bytes'] / 1e6:.1f}MB "
              f"achieved_GBps={case['bytes'] / ms / 1e6:.1f}", flush=True)
        if rec is None:
            plain_ms = time_ms(lambda: paged.paged_decode_plain(
                q, kp, vp, tables, pos), reps=5, warmup=1)
            rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": by, "library_ms": None}
            print(f"paged_decode {label}: plain_ms={plain_ms:.4f}",
                  flush=True)
        del case, q, kp, vp
        torch.cuda.empty_cache()
    if kinds != {False, True}:
        fail("the held decode cases do not cover both grids (one split "
             "and several)")
    rec["max_abs_err"] = worst
    return rec


DECODE_STREAM_ITERS = 100


def check_decode_streams(torch, paged, gen):
    """Two streams launch multi-split decode at once, in a loop: case a
    (llama3_8b, 8 rows) on one and case c (gemma_2b MQA) on the other.
    Each stream keeps its own merge counters, so every output must match
    the plain version (OUT_ATOL/OUT_RTOL) and its stream's first output
    bitwise."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    specs = [decode_cases()[0], decode_cases()[2]]
    cases, refs = [], []
    for spec in specs:
        case = decode_case(torch, gen, *spec)
        B, H, KV, Hd, page, maxp = case["shape"]
        if paged.decode_splits(B, H, KV, page, maxp, sms) < 2:
            fail(f"two-stream decode check: case {case['label']} runs one "
                 "split; it needs several")
        args = (*case["ins"][0], case["tables"], case["pos"])
        cases.append(args)
        refs.append(paged.paged_decode_plain(*args))
        del case
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(DECODE_STREAM_ITERS):
        for i, (st, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                outs[i].append(paged.paged_decode_attention(*args))
    torch.cuda.synchronize()
    for spec, ref, got in zip(specs, refs, outs):
        if not close(got[0], ref):
            err = (got[0].float() - ref.float()).abs().max().item()
            fail(f"two-stream decode ({spec[0]}): disagrees with its plain "
                 f"version, max abs err {err}")
        differ = sum(not torch.equal(o, got[0]) for o in got)
        if differ:
            fail(f"two-stream decode ({spec[0]}): {differ} of {len(got)} "
                 "launches differ from the first")
    print(f"paged_decode two streams: {DECODE_STREAM_ITERS} concurrent "
          f"multi-split launches per stream ({specs[0][0]} | {specs[1][0]})"
          f", all equal to the plain version and bitwise to each other",
          flush=True)
    del cases, refs, outs
    torch.cuda.empty_cache()


def _bwd_close(got, want) -> bool:
    import torch

    want = want.float()
    return torch.allclose(got.float(), want, rtol=BWD_RTOL,
                          atol=BWD_ATOL_REL * want.abs().max().item())


def _bwd_inputs(torch, flash, gen, B, S, H, KV, D, seg, dlse: bool,
                causal: bool = True):
    q = torch.randn(B, S, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    o, lse = flash.flash_fwd_cuda(q, k, v, causal=causal, scale=D ** -0.5,
                                  segment_ids=seg)
    dl = (0.1 * torch.randn(B, H, S, generator=gen, device="cuda")
          if dlse else None)
    return q, k, v, seg, o, lse, do, dl


def flash_bwd_plain_bf16(q, k, v, segment_ids, o, lse, do, dlse, *,
                         causal: bool, scale: float, window=None):
    """``flash_bwd_plain`` with the kernels' two roundings: P and dS are
    rounded to bf16 where they enter the tensor-core products
    (dV = bf16(P)^T dO, dK = bf16(dS)^T Q, dQ = bf16(dS) K); all else
    is f32, as in the plain version. What the kernels should compute up
    to the order of their f32 sums."""
    import torch
    from polyaxon_tpu_torch.ops import flash

    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    qf = q.float()
    kf, vf = flash._expand_kv(k, n_rep), flash._expand_kv(v, n_rep)
    dof = torch.zeros_like(qf) if do is None else do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    mask = flash._plain_mask(sq, sk, causal, window, segment_ids,
                             segment_ids, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf).mul_(scale)
    p = torch.where(mask, s.sub_(lse[..., None]).exp_(), 0.0)
    del s
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = ds.sub_(delta[..., None]).mul_(p).mul_(scale).bfloat16().float()
    p = p.bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(
        b, sk, kv, n_rep, d).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(
        b, sk, kv, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_flash_bwd(torch, flash, peaks, gen):
    """Both backward kernels against ``flash_bwd_plain`` in bf16, then
    timed. Returns the two records for the kernels line."""
    from polyaxon_tpu_torch.runtime.data import lm_packed_synthetic

    segs = {b: torch.from_numpy(next(lm_packed_synthetic(
        b, seq_len=4096, vocab_size=128_256, seed=SEED))["segments"]).cuda()
        for b in (1, 4)}
    split_fn = flash._bwd_entries()[2]
    worst = {"dkdv": 0.0, "dq": 0.0}
    splits = set()
    for label, shape, s in (
            ("llama3_1b packed B=4 S=4096 H32 KV8 D64",
             (4, 4096, 32, 8, 64), segs[4]),
            ("llama3_1b packed B=1 S=4096 H32 KV8 D64",
             (1, 4096, 32, 8, 64), segs[1]),
            ("ragged S=1000 GQA 4:1 D128", (1, 1000, 32, 8, 128), None),
            ("gemma_2b packed S=4096 H8 KV1 D256", (1, 4096, 8, 1, 256),
             segs[1])):
        args = _bwd_inputs(torch, flash, gen, *shape, s, dlse=True)
        B, S, H, KV, D = shape
        n_split = split_fn(B, S, H, KV, D)
        splits.add(n_split > 1)
        got = flash.flash_bwd_cuda(*args, causal=True, scale=D ** -0.5)
        torch.cuda.synchronize()
        want = flash.flash_bwd_plain(*args, causal=True, scale=D ** -0.5)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(g).all():
                fail(f"flash backward {name} non-finite ({label})")
            errs[name] = (g.float() - w.float()).abs().max().item()
            if not _bwd_close(g, w):
                fail(f"flash backward {name} disagrees with its plain "
                     f"version ({label}): max abs err {errs[name]}, max "
                     f"|plain| {w.float().abs().max().item()} (atol "
                     f"{BWD_ATOL_REL} * max|plain| + rtol {BWD_RTOL})")
        worst["dq"] = max(worst["dq"], errs["dq"])
        worst["dkdv"] = max(worst["dkdv"], errs["dk"], errs["dv"])
        del want
        emul = flash_bwd_plain_bf16(*args, causal=True, scale=D ** -0.5)
        emul_errs = " ".join(
            f"{n}={(g.float() - w.float()).abs().max().item():.3e}"
            for n, g, w in zip(("dq", "dk", "dv"), got, emul))
        print(f"flash_bwd {label} (dkdv_head_split={n_split}): "
              f"max_abs_err dq={errs['dq']:.3e} "
              f"dk={errs['dk']:.3e} dv={errs['dv']:.3e}; against the plain "
              f"version with P and dS in bf16: {emul_errs}", flush=True)
        del args, got, emul
        torch.cuda.empty_cache()
    if splits != {False, True}:
        fail("the held backward cases do not cover both dK/dV grids "
             "(in-block group loop and head split)")

    # Times at one microbatch of each training path (llama3_1b: B=4,
    # S=4096, D=64, the kernels line's record; gemma_2b: B=1, S=4096,
    # D=256), no segments, no lse cotangent, so SDPA's backward is the
    # same function; then the pair again with the path's packed segments.
    recs = time_flash_bwd(torch, flash, peaks, gen, 4, 4096, 32, 8, 64,
                          segs[4])
    time_flash_bwd(torch, flash, peaks, gen, 1, 4096, 8, 1, 256, segs[1])
    for name in recs:
        recs[name]["max_abs_err"] = worst[name]
    return recs


def time_flash_bwd(torch, flash, peaks, gen, B, S, H, KV, D, seg):
    """Times of the backward pair, its plain version and SDPA's backward
    at one causal shape, and of the pair with the packed segments ``seg``
    [B, S]; returns the two kernels' records (without max_abs_err)."""
    import torch.nn.functional as F

    args = _bwd_inputs(torch, flash, gen, B, S, H, KV, D, None, dlse=False)
    kw = dict(causal=True, scale=D ** -0.5)
    run_dkdv, run_dq, _ = flash._bwd_launchers(*args, **kw)
    dkdv_ms = time_ms(run_dkdv, reps=20)
    dq_ms = time_ms(run_dq, reps=20)
    pair_ms = time_ms(lambda: flash.flash_bwd_cuda(*args, **kw), reps=20)
    plain_ms = time_ms(lambda: flash.flash_bwd_plain(*args, **kw), reps=3,
                       warmup=1)
    q, k, v, _, _, _, do, _ = args
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), reps=20)
    pairs = B * H * S * (S + 1) / 2  # visible (q, key) pairs, causal
    qbytes, kvbytes, rowbytes = 2.0 * B * S * H * D, 2.0 * B * S * KV * D, \
        4.0 * B * H * S
    inputs = 2 * qbytes + 2 * kvbytes + 2 * rowbytes  # q, do, k, v, lse, dd
    # Products of head_dim per pair each kernel does: dQ recomputes S and
    # dP; at head_dim 256 the two consumer warpgroups of a block each own
    # half of the output's columns and both compute S and dP.
    done = {"dkdv": 6, "dq": 5} if D == 256 else {"dkdv": 4, "dq": 3}
    recs = {}
    # The pair's minimal work, split so that the two bounds add up to it:
    # 5 products of head_dim per visible pair (S and dP once, then dV, dK
    # and dQ), each input read once and each output written once. dK/dV
    # is charged S, dP, dV, dK and the inputs; dQ only its own product and
    # its output.
    for name, n_prod, nbytes, ms in (
            ("dkdv", 4, inputs + 2 * kvbytes, dkdv_ms),
            ("dq", 1, qbytes, dq_ms)):
        flops = 2.0 * D * n_prod * pairs
        t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
        recs[name] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(t_ops, t_bytes) * 1e3,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "library_ms": lib_ms}
        print(f"flash_bwd {name} B={B} S={S} H={H} KV={KV} D={D}: "
              f"kernel_ms={ms:.4f} "
              f"bound_ms={recs[name]['bound_ms']:.4f} "
              f"({recs[name]['bound_by']}) TFLOPs_done="
              f"{2.0 * D * done[name] * pairs / ms / 1e9:.1f}", flush=True)
    del args, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    args = _bwd_inputs(torch, flash, gen, B, S, H, KV, D, seg, dlse=False)
    packed_ms = time_ms(lambda: flash.flash_bwd_cuda(*args, **kw), reps=20)
    print(f"flash_bwd pair B={B} S={S} H={H} KV={KV} D={D}: "
          f"wrapper_ms={pair_ms:.4f} "
          f"(dkdv+dq {dkdv_ms + dq_ms:.4f}) packed_wrapper_ms="
          f"{packed_ms:.4f} plain_ms={plain_ms:.4f} "
          f"sdpa_bwd_ms={lib_ms:.4f} bound_ms="
          f"{recs['dkdv']['bound_ms'] + recs['dq']['bound_ms']:.4f} "
          f"(5 products) dkdv_head_split="
          f"{flash._bwd_entries()[2](B, S, H, KV, D)}", flush=True)
    del args
    torch.cuda.empty_cache()
    return recs


# The flash kernels at the shapes phases 11-13 and 17 give them (D=64):
# t5's encoder, non-causal, in training (t5_base at S=512, 12:12 heads,
# the microbatch of phase 13) and served (one ragged encoder length);
# t5's decoder self-attention, causal, at the same microbatch;
# moe_8x200m's training microbatch (B=4, S=2048, 16:8 heads), causal;
# and the ring's blocks at llama3_1b's 32,768-token row (32:8 heads):
# at cp=1 the half-row causal diagonals and the non-causal hi-lo block
# (S_loc/2 = 16,384), at cp=4 the 4,096-row diagonals and ring-step
# blocks.
# And the tp-local heads of phase 18 and of the four-card tp4 gangs:
# llama3_8b at tp4 (8:2 heads, D=128, one 4,096-token row) and llama3_1b
# at tp4 (8:2 heads, D=64, four rows); and of phase 19's tp2 prefill
# (16:4 heads, one 2,048-token prompt). And phase 21's pairs: llama3_8b's
# tp2 heads (16:4, D=128) over a 4,096-token microbatch (pp2 x tp2) and
# as tp2 x cp2's zigzag blocks (S/(2 cp) = 1,024 rows, causal diagonals
# and full blocks), moe_8x200m's tp2 heads (8:4) at its training
# microbatch, and the four-card tp_cp gang's blocks (llama3_1b's 16:4 at
# 32,768 tokens over cp2: 8,192-row chunks).
PATH_CASES = (("t5_base encoder training B=32 S=512", 32, 512, 12, 12, False,
               64),
              ("t5_base served encoder S=300", 1, 300, 12, 12, False, 64),
              ("t5_base decoder training B=32 S=512", 32, 512, 12, 12, True,
               64),
              ("moe_8x200m training B=4 S=2048", 4, 2048, 16, 8, True, 64),
              ("ring cp=1 diagonal S=16384", 1, 16384, 32, 8, True, 64),
              ("ring cp=1 hi-lo block S=16384", 1, 16384, 32, 8, False, 64),
              ("ring cp=4 diagonal S=4096", 1, 4096, 32, 8, True, 64),
              ("ring cp=4 step block S=4096", 1, 4096, 32, 8, False, 64),
              ("llama3_8b tp4 B=1 S=4096", 1, 4096, 8, 2, True, 128),
              ("llama3_8b tp2 prefill B=1 S=2048", 1, 2048, 16, 4, True,
               128),
              ("llama3_1b tp4 B=4 S=4096", 4, 4096, 8, 2, True, 64),
              ("llama3_8b pp2 x tp2 B=1 S=4096", 1, 4096, 16, 4, True, 128),
              ("llama3_8b tp2 x cp2 diagonal S=1024", 1, 1024, 16, 4, True,
               128),
              ("llama3_8b tp2 x cp2 step block S=1024", 1, 1024, 16, 4,
               False, 128),
              ("moe_8x200m tp2 B=4 S=2048", 4, 2048, 8, 4, True, 64),
              ("llama3_1b tp2 x cp2 diagonal S=8192", 1, 8192, 16, 4, True,
               64),
              ("llama3_1b tp2 x cp2 step block S=8192", 1, 8192, 16, 4,
               False, 64))
# The plain versions hold f32 [B, h, S, S] scores: past this many bytes
# they run on the first KV group's heads only (the kernels run on all of
# them; the plain time is scaled up to all heads).
PLAIN_SCORE_BYTES = 8e9


def plain_heads(B: int, S: int, H: int, KV: int) -> int:
    """Query heads the plain versions hold: all, or whole KV groups
    within PLAIN_SCORE_BYTES (at least one)."""
    group = H // KV
    fit = int(PLAIN_SCORE_BYTES // (4.0 * B * S * S * group))
    return H if fit >= KV else group * max(fit, 1)


def _head_slice(args, h: int, H: int, KV: int):
    """The backward's (q, k, v, seg, o, lse, do, dlse) on the first h
    query heads and their KV heads."""
    kvh = h * KV // H
    q, k, v, seg, o, lse, do, dlse = args
    return (q[:, :, :h], k[:, :, :kvh], v[:, :, :kvh], seg, o[:, :, :h],
            lse[:, :h], do[:, :, :h], None if dlse is None else dlse[:, :h])


def check_path_shapes(torch, flash, peaks, gen):
    """The forward and the backward pair at PATH_CASES: each against its
    plain version, then timed beside SDPA (``is_causal`` as the case),
    the bounds counting the visible pairs (all S^2 without a causal
    mask); the plain versions on ``plain_heads`` of the heads. Returns
    the worst errors {"fwd", "dkdv", "dq"} and the records."""
    import torch.nn.functional as F

    worst = {"fwd": 0.0, "dkdv": 0.0, "dq": 0.0}
    recs = {}
    for label, B, S, H, KV, causal, D in PATH_CASES:
        mask = "causal" if causal else "non-causal"
        h = plain_heads(B, S, H, KV)
        kvh = h * KV // H
        args = _flash_inputs(torch, gen, B, S, H, KV, D)
        worst["fwd"] = max(worst["fwd"], hold_flash(
            torch, flash, f"{label} {mask}", *args, causal=causal, heads=h))
        recs[f"fwd {label}"] = time_flash(torch, flash, peaks,
                                          f"{label} {mask}", *args,
                                          causal=causal, heads=h)
        del args
        args = _bwd_inputs(torch, flash, gen, B, S, H, KV, D, None,
                           dlse=True, causal=causal)
        kw = dict(causal=causal, scale=D ** -0.5)
        got = flash.flash_bwd_cuda(*args, **kw)
        got = (got[0][:, :, :h], got[1][:, :, :kvh], got[2][:, :, :kvh])
        torch.cuda.synchronize()
        want = flash.flash_bwd_plain(*_head_slice(args, h, H, KV), **kw)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(g).all():
                fail(f"flash backward {name} non-finite ({label}, {mask})")
            errs[name] = (g.float() - w.float()).abs().max().item()
            if not _bwd_close(g, w):
                fail(f"flash backward {name} disagrees with its plain "
                     f"version ({label}, {mask}): max abs err "
                     f"{errs[name]}, max |plain| "
                     f"{w.float().abs().max().item()} (atol "
                     f"{BWD_ATOL_REL} * max|plain| + rtol {BWD_RTOL})")
        worst["dq"] = max(worst["dq"], errs["dq"])
        worst["dkdv"] = max(worst["dkdv"], errs["dk"], errs["dv"])
        held = f" (first {h} of {H} heads)" if h < H else ""
        print(f"flash_bwd {label} {mask}: max_abs_err "
              f"dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e}"
              f"{held}", flush=True)
        del got, want, args
        args = _bwd_inputs(torch, flash, gen, B, S, H, KV, D, None,
                           dlse=False, causal=causal)
        run_dkdv, run_dq, _ = flash._bwd_launchers(*args, **kw)
        dkdv_ms = time_ms(run_dkdv, reps=20)
        dq_ms = time_ms(run_dq, reps=20)
        sliced = _head_slice(args, h, H, KV)
        plain_ms = time_ms(lambda: flash.flash_bwd_plain(*sliced, **kw),
                           reps=3, warmup=1) * H / h
        del sliced
        q, k, v, _, _, _, do, _ = args
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            enable_gqa=KV < H)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), reps=20)
        pairs = B * H * (S * (S + 1) / 2 if causal else S * S)
        qbytes, kvbytes, rowbytes = (2.0 * B * S * H * D,
                                     2.0 * B * S * KV * D, 4.0 * B * H * S)
        inputs = 2 * qbytes + 2 * kvbytes + 2 * rowbytes  # q do k v lse dd
        for name, n_prod, nbytes, ms in (
                ("dkdv", 4, inputs + 2 * kvbytes, dkdv_ms),
                ("dq", 1, qbytes, dq_ms)):
            t_ops = 2.0 * D * n_prod * pairs / peaks[0]
            t_bytes = nbytes / peaks[1]
            rec = {"ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes
                   else "bytes", "library_ms": lib_ms}
            recs[f"{name} {label}"] = rec
            print(f"flash_bwd {name} {label} {mask} H={H} KV={KV} D={D}: "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"sdpa_bwd_ms={lib_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
                  f"({rec['bound_by']})", flush=True)
        del args, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()
    return worst, recs


# -------------------------------------------------------------- model
def make_prompts(vocab: int):
    """16 prompts of mixed lengths: six share a 256-token system prefix
    (radix hits on whole pages), two more share it up to a mid-page
    point (copy-on-write forks)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    system = rng.integers(0, vocab, 256).tolist()
    lengths = [1000, 37, 512, 300, 2047, 64, 800, 129]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lengths]
    for n in (40, 90, 200, 7, 333, 64):
        prompts.append(system + rng.integers(0, vocab, n).tolist())
    for n in (120, 15):
        prompts.append(system[:200] + rng.integers(0, vocab, n).tolist())
    return prompts


def compare_first_admission(torch, llama, cfg, params, prompt):
    """The first admission's prefill KV and first decode logits through
    the kernels ("auto") against the plain path (einsum prefill, gather
    decode), on one fresh pool."""
    page = 16
    P = len(prompt) - 1
    n_pages = -(-(P + 1) // page) + 1
    tables = torch.full((1, n_pages), -1, dtype=torch.long, device="cuda")
    tables[0, :n_pages - 1] = torch.arange(1, n_pages, device="cuda")
    row = torch.tensor([prompt[:-1]], dtype=torch.long, device="cuda")
    tok = torch.tensor([prompt[-1]], dtype=torch.long, device="cuda")
    pos = torch.tensor([P], dtype=torch.long, device="cuda")
    plain = dataclasses.replace(cfg, attention_impl="xla",
                                paged_attention_impl="gather")
    results = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        cache = llama.paged_init_cache(c, n_pages, page, device="cuda")
        k, v = llama.paged_prefill_kv(c, params, row)
        llama.paged_insert_prefill(cache, k, v, tables[0], page)
        logits, _ = llama.decode_step_paged(c, params, cache, tok, pos,
                                            tables)
        torch.cuda.synchronize()
        results[name] = (k, v, logits)
        del cache
    out = {}
    for i, what in enumerate(("k", "v", "logits")):
        a, b = results["kernel"][i].float(), results["plain"][i].float()
        if not torch.isfinite(a).all():
            fail(f"first admission: non-finite {what} on the kernel path")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        out[what] = rel
        if rel > MODEL_REL_TOL:
            fail(f"first admission {what}: kernel path vs plain path "
                 f"relative max err {rel} (tol {MODEL_REL_TOL})")
    same_argmax = bool(results["kernel"][2].argmax() ==
                       results["plain"][2].argmax())
    print(f"first admission (prompt {len(prompt)}): rel err k={out['k']:.3e} "
          f"v={out['v']:.3e} logits={out['logits']:.3e} "
          f"same_argmax={same_argmax}", flush=True)


def time_prefill(torch, llama, flash, cfg, params):
    """Device time of one 2,048-token llama3_8b prompt pass (the prefill's
    KV, 32 flash forward launches), by CUDA events."""
    row = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            SEED))
    before = flash.launches
    ms = time_ms(lambda: llama.paged_prefill_kv(cfg, params, row), reps=5,
                 warmup=1)
    per = (flash.launches - before) // 6
    print(f"prefill llama3_8b 2048 tokens: ms={ms:.2f} "
          f"flash_fwd_launches_per_prefill={per}", flush=True)


def run_engine(flash, paged, cfg, params):
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine

    prompts = make_prompts(cfg.vocab_size)
    eng = ContinuousBatchingEngine("llama3_8b", cfg, params, slots=8,
                                   kv="paged", page_size=16, device="cuda")
    try:
        _zero(flash, paged)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, 32) for p in prompts]
        outs = [r.wait(timeout=900) for r in reqs]
        wall = time.perf_counter() - t0
        counts = _counts(flash, paged)
        stats = eng.stats()
        bad = eng.check_invariants()
    finally:
        eng.stop()
    if bad:
        fail(f"page pool invariants broken: {bad[:5]}")
    for p, o in zip(prompts, outs):
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"engine output malformed for a prompt of {len(p)}: {o}")
    for name in SERVING_KERNELS:
        if counts[name] <= 0:
            fail(f"main path never launched the {name} kernel")
    tokens = sum(len(o) for o in outs)
    print(f"engine llama3_8b: requests={len(prompts)} tokens={tokens} "
          f"wall_s={wall:.3f} tokens_per_s={tokens / wall:.1f} "
          f"decode_step_ms_median={stats['decode_step_ms_median']:.3f} "
          f"decode_steps={stats['decode_steps']} "
          f"avg_occupancy={stats['avg_occupancy']} "
          f"prefill_tokens={stats['prefill_tokens_total']} "
          f"skipped={stats['prefill_tokens_skipped']} "
          f"cow_forks={stats['kv_cow_forks']} launches={counts}",
          flush=True)
    return counts, prompts, stats


def run_http(flash, paged):
    from polyaxon_tpu_torch.serving.server import ServingServer

    results, errors = [None, None], []

    def post(i, url):
        body = json.dumps({"tokens": [[7 + i, 8, 9, 10 + i] * (5 + i)],
                           "max_new_tokens": 8}).encode()
        req = urllib.request.Request(
            f"{url}/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                results[i] = json.loads(resp.read())
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(f"{type(exc).__name__}: {exc}")

    before = (flash.launches, paged.launches)
    with ServingServer("llama3_8b", seed=SEED, slots=4,
                       batching="continuous", kv="paged",
                       device="cuda") as srv:
        threads = [threading.Thread(target=post, args=(i, srv.url))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            fail("HTTP requests did not finish")
        with urllib.request.urlopen(f"{srv.url}/v1/stats") as resp:
            served = json.loads(resp.read())["requests_served"]
    if errors:
        fail(f"HTTP generate failed: {errors}")
    if any(r is None or len(r["tokens"][0]) != 8 for r in results) \
            or served != 2:
        fail(f"HTTP answers malformed: {results}, served {served}")
    moved = (flash.launches > before[0], paged.launches > before[1])
    if not all(moved):
        fail("HTTP path did not launch both kernels")
    print(f"http: 2 POST /v1/generate answered, served={served}",
          flush=True)


# ------------------------------------------- the rest of serving (a-g)
# Greedy output is checked up to near-ties. The logits leave the lm_head
# product in bf16, so two computations of them (a decode step and a
# verify chunk, a row batched with 7 others and alone, a decode step and
# a prompt pass) differ in steps of the bf16 spacing at the largest
# logit's magnitude; phase a measures 1.4-1.6e-2 of the largest logit
# between paths, about 2.5 such steps. A near-tie is a gap within
# NEAR_TIE_ULPS of them: an argmax may differ there and nowhere else.
NEAR_TIE_ULPS = 8
# int8 logits against bf16's: the JAX package's own bound
# (tests/test_serving.py::TestQuantize::test_logit_parity_bounded), the
# largest error within 5% of the largest bf16 logit.
INT8_REL_TOL = 5e-2
DENSE_MAX_LEN = 4096
DENSE_NEW_TOKENS = 32
CHUNK_PROMPT = 2047
PREFILL_CHUNK = 512
MISTRAL_PROMPT = 4000
MISTRAL_NEW = 256
SPEC_K = 4


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


# The kernels a paged serving path launches (the backward pair's counts
# stay 0 there).
SERVING_KERNELS = ("flash_fwd", "paged_decode")


def _counts(flash, paged) -> dict:
    """The launches of the four kernels since the last ``_zero``."""
    return {"flash_fwd": flash.launches,
            "flash_bwd_dkdv": flash.bwd_dkdv_launches,
            "flash_bwd_dq": flash.bwd_dq_launches,
            "paged_decode": paged.launches}


def _zero(flash, paged) -> None:
    flash.launches = flash.bwd_dkdv_launches = flash.bwd_dq_launches = 0
    paged.launches = 0


def _run_engine_mix(eng, prompts, new_tokens, **submit_kw):
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new_tokens, **submit_kw) for p in prompts]
    outs = [r.wait(timeout=900) for r in reqs]
    wall = time.perf_counter() - t0
    return reqs, outs, wall


def _check_outs(label, prompts, outs, new_tokens, vocab):
    for p, o in zip(prompts, outs):
        if len(o) != new_tokens or not all(0 <= t < vocab for t in o):
            fail(f"{label}: malformed output for a prompt of {len(p)}: {o}")


def _teacher_logits(torch, llama, cfg, params, prompt, toks):
    """The target's f32 logits predicting each of ``toks`` after
    ``prompt`` ([len(toks), V]): one prompt pass over prompt + toks
    through the kernel path, only the predicting rows projected.
    ``llama`` is the target's family module (llama or moe, whose
    ``hidden_states`` also returns the router aux)."""
    row = torch.tensor([prompt + toks[:-1]], dtype=torch.long,
                       device="cuda")
    x = llama.hidden_states(cfg, params, row)
    if isinstance(x, tuple):
        x = x[0]
    x = x[0, len(prompt) - 1:]
    return (x @ llama.lm_head(cfg, params).to(cfg.dtype)).float()


def _tie_tol(torch, logits):
    """NEAR_TIE_ULPS bf16 spacings at each row's largest |logit|."""
    top = logits.abs().amax(dim=-1).clamp(min=2.0 ** -100)
    return NEAR_TIE_ULPS * torch.exp2(torch.floor(torch.log2(top)) - 7)


def near_tie_check(torch, llama, cfg, params, label, prompt, got, want):
    """Greedy ``got`` against the reference greedy ``want`` after
    ``prompt``: equal up to their first divergence, which must sit at a
    near-tie of the target's logits (teacher-forced on ``want``); and
    every token of ``got`` must be the target's argmax given its own
    prefix, or within a near-tie of it. Returns the divergence index
    (None when equal) and the share of ``want``'s positions that are
    near-ties (how often the rule could excuse a divergence)."""
    if len(got) != len(want):
        fail(f"{label}: {len(got)} tokens against {len(want)}")
    lw = _teacher_logits(torch, llama, cfg, params, prompt, want)
    top2 = torch.topk(lw, 2, dim=-1).values
    gaps = top2[:, 0] - top2[:, 1]
    tol = _tie_tol(torch, lw)
    share = (gaps < tol).float().mean().item()
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    if j is not None and gaps[j] >= tol[j]:
        fail(f"{label}: diverged at token {j} ({got[j]} vs {want[j]}) "
             f"where the top-2 gap {gaps[j].item():.4f} is not a near-tie "
             f"(tol {tol[j].item():.4f})")
    lg = lw if j is None else _teacher_logits(torch, llama, cfg, params,
                                              prompt, got)
    _check_own_choice(torch, label, lg, got)
    if j is not None:
        print(f"  {label}: near-tie divergence at token {j}: gap "
              f"{gaps[j].item():.4f} < tol {tol[j].item():.4f}; "
              f"near-tie share {share:.3f}", flush=True)
    return j, share


def _check_own_choice(torch, label, logits, toks):
    """Fails unless each of ``toks`` is the argmax of its row of the
    teacher's ``logits`` (the target given the row's own prefix), or
    within a near-tie of it."""
    picked = logits.gather(1, torch.tensor(toks, device="cuda")[:, None])[:, 0]
    short = logits.amax(dim=-1) - picked
    tol = _tie_tol(torch, logits)
    bad = (short >= tol).nonzero().flatten().tolist()
    if bad:
        i = bad[0]
        fail(f"{label}: token {i} ({toks[i]}) is {short[i].item():.4f} below "
             f"the target's argmax given its own prefix (tol "
             f"{tol[i].item():.4f})")


def dense_static(torch, llama, flash, paged, cfg, params, prompts,
                 paged_stats):
    """Phase a: the dense and static engines over llama3_8b. Returns
    (launch counts, the dense engine's greedy outputs)."""
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import _Engine

    t_phase = time.perf_counter()
    eng = ContinuousBatchingEngine("llama3_8b", cfg, params, slots=8,
                                   max_len=DENSE_MAX_LEN, kv="dense",
                                   device="cuda")
    try:
        _zero(flash, paged)
        _, outs, wall = _run_engine_mix(eng, prompts, DENSE_NEW_TOKENS)
        torch.cuda.synchronize()
        dense_counts = _counts(flash, paged)
        stats = eng.stats()
    finally:
        eng.stop()
    _check_outs("dense engine", prompts, outs, DENSE_NEW_TOKENS,
                cfg.vocab_size)
    if dense_counts["flash_fwd"] <= 0:
        fail("the dense engine never launched the flash forward kernel")
    tokens = sum(len(o) for o in outs)
    print(f"a. dense engine llama3_8b: requests={len(prompts)} "
          f"tokens={tokens} wall_s={wall:.3f} "
          f"tokens_per_s={tokens / wall:.1f} "
          f"decode_step_ms_median={stats['decode_step_ms_median']:.3f} "
          f"decode_steps={stats['decode_steps']} "
          f"avg_occupancy={stats['avg_occupancy']} launches={dense_counts} "
          f"(paged, phase 2: decode_step_ms_median="
          f"{paged_stats['decode_step_ms_median']:.3f})", flush=True)

    static = _Engine("llama3_8b", cfg, params, device="cuda")
    rows = [prompts[i] for i in (1, 3, 5, 7)]
    _zero(flash, paged)
    t0 = time.perf_counter()
    souts = static.generate(rows, DENSE_NEW_TOKENS)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    static_counts = _counts(flash, paged)
    _check_outs("static engine", rows, souts, DENSE_NEW_TOKENS,
                cfg.vocab_size)
    if static_counts["flash_fwd"] <= 0:
        fail("the static engine never launched the flash forward kernel")
    same = sum(o == outs[i] for o, i in zip(souts, (1, 3, 5, 7)))
    # Every greedy row is the target's argmax given its own prefix, up to
    # near-ties; the static rows equal the dense engine's up to the rule.
    shares = [near_tie_check(torch, llama, cfg, params, f"dense row {i}",
                             p, o, o)[1] for i, (p, o) in
              enumerate(zip(prompts, outs))]
    for o, i in zip(souts, (1, 3, 5, 7)):
        near_tie_check(torch, llama, cfg, params, f"static row {i}",
                       prompts[i], o, outs[i])
    print(f"a. static engine llama3_8b: requests={len(rows)} "
          f"tokens={sum(map(len, souts))} wall_s={swall:.3f} "
          f"tokens_per_s={sum(map(len, souts)) / swall:.1f} "
          f"rows_equal_to_dense={same}/{len(rows)}; every dense and "
          f"static token the target's greedy choice up to near-ties "
          f"(NEAR_TIE_ULPS={NEAR_TIE_ULPS}, near-tie share of positions "
          f"{min(shares):.3f}-{max(shares):.3f}); "
          f"launches={static_counts}", flush=True)

    # First admission: dense kernel path vs the paged engine's path and
    # vs the dense plain path (einsum prefill).
    prompt = prompts[0]
    row = torch.tensor([prompt[:-1]], dtype=torch.long, device="cuda")
    tok = torch.tensor([prompt[-1]], dtype=torch.long, device="cuda")
    pos = torch.tensor([len(prompt) - 1], dtype=torch.long, device="cuda")
    plain = dataclasses.replace(cfg, attention_impl="xla")
    dense = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        cache = llama.cb_prefill(c, params, row, DENSE_MAX_LEN)
        dense[name] = llama.decode_step_ragged(c, params, cache, tok,
                                               pos)[0][0]
        del cache
    page = 16
    n_pages = -(-len(prompt) // page) + 1
    tables = torch.full((1, n_pages), -1, dtype=torch.long, device="cuda")
    tables[0, :n_pages - 1] = torch.arange(1, n_pages, device="cuda")
    pcache = llama.paged_init_cache(cfg, n_pages, page, device="cuda")
    k, v = llama.paged_prefill_kv(cfg, params, row)
    llama.paged_insert_prefill(pcache, k, v, tables[0], page)
    paged_logits = llama.decode_step_paged(cfg, params, pcache, tok, pos,
                                           tables)[0][0]
    del pcache, k, v
    rel_paged = _rel(dense["kernel"], paged_logits)
    rel_plain = _rel(dense["kernel"], dense["plain"])
    for what, rel in (("paged engine", rel_paged), ("plain path", rel_plain)):
        if not torch.isfinite(dense["kernel"]).all() or rel > MODEL_REL_TOL:
            fail(f"dense first admission vs the {what}: relative max err "
                 f"{rel} (tol {MODEL_REL_TOL})")

    # Chunked prefill of a 2,047-token prompt vs the unchunked prefill.
    cprompt = prompts[4]
    assert len(cprompt) == CHUNK_PROMPT
    pre = cprompt[:-1]
    tok = torch.tensor([cprompt[-1]], dtype=torch.long, device="cuda")
    pos = torch.tensor([len(pre)], dtype=torch.long, device="cuda")
    mono = llama.cb_prefill(cfg, params, torch.tensor(
        [pre], dtype=torch.long, device="cuda"), DENSE_MAX_LEN)
    mono_logits = llama.decode_step_ragged(cfg, params, mono, tok, pos)[0][0]
    del mono
    chunked = llama.cb_init_cache(cfg, 1, DENSE_MAX_LEN, device="cuda")
    for i in range(0, len(pre), PREFILL_CHUNK):
        part = pre[i:i + PREFILL_CHUNK]
        part = part + [0] * (PREFILL_CHUNK - len(part))
        llama.decode_chunk(cfg, params, chunked, torch.tensor(
            [part], dtype=torch.long, device="cuda"),
            torch.tensor([i], dtype=torch.long, device="cuda"))
    chunk_logits = llama.decode_step_ragged(cfg, params, chunked, tok,
                                            pos)[0][0]
    del chunked
    rel_chunk = _rel(chunk_logits, mono_logits)
    if rel_chunk > MODEL_REL_TOL:
        fail(f"chunked prefill ({PREFILL_CHUNK}) vs unchunked: relative "
             f"max err {rel_chunk} (tol {MODEL_REL_TOL})")
    ceng = ContinuousBatchingEngine("llama3_8b", cfg, params, slots=2,
                                    max_len=DENSE_MAX_LEN,
                                    prefill_chunk=PREFILL_CHUNK,
                                    device="cuda")
    try:
        _zero(flash, paged)
        _, couts, cwall = _run_engine_mix(ceng, [cprompt, prompts[1]],
                                          DENSE_NEW_TOKENS)
        chunk_counts = _counts(flash, paged)
    finally:
        ceng.stop()
    _check_outs("chunked engine", [cprompt, prompts[1]], couts,
                DENSE_NEW_TOKENS, cfg.vocab_size)
    near_tie_check(torch, llama, cfg, params, "chunked engine", cprompt,
                   couts[0], outs[4])
    print(f"a. first admission (prompt {len(prompt)}): dense vs paged rel "
          f"err {rel_paged:.3e}, dense kernel vs plain {rel_plain:.3e}; "
          f"chunked prefill {PREFILL_CHUNK} vs unchunked "
          f"({CHUNK_PROMPT}-token prompt) {rel_chunk:.3e}; chunked engine "
          f"wall_s={cwall:.3f} launches={chunk_counts}; "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    counts = {k: dense_counts[k] + static_counts[k] + chunk_counts[k]
              for k in dense_counts}
    return counts, outs


def speculation(torch, llama, flash, paged, cfg, params, prompts, want):
    """Phase c: llama3_8b with llama3_draft_200m drafting k=4 tokens,
    greedy, through the dense engine and the static engine; each row's
    tokens equal the non-speculative dense engine's (``want``) up to the
    near-tie rule. Random weights make the small draft's proposals all
    rejected, so a second run has llama3_8b draft for itself: its
    proposals are the target's own decode-step argmaxes, most of them
    accepted, which drives the accepted-token path (multi-token commits,
    draft and target caches advancing together) under the same rule."""
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import _Engine, load_params

    t_phase = time.perf_counter()
    dcfg, dparams = load_params("llama3_draft_200m", seed=SEED,
                                device="cuda")
    draft = ("llama3_draft_200m", dcfg, dparams, SPEC_K)
    idx = (1, 3, 5, 7)
    rows = [prompts[i] for i in idx]
    eng = ContinuousBatchingEngine("llama3_8b", cfg, params, slots=8,
                                   max_len=DENSE_MAX_LEN, draft=draft,
                                   device="cuda")
    try:
        _zero(flash, paged)
        _, souts, wall = _run_engine_mix(eng, rows, DENSE_NEW_TOKENS)
        engine_counts = _counts(flash, paged)
        stats = eng.stats()
    finally:
        eng.stop()
    _zero(flash, paged)
    t0 = time.perf_counter()
    static = _Engine("llama3_8b", cfg, params, draft=draft, device="cuda")
    touts = static.generate(rows, DENSE_NEW_TOKENS)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    static_counts = _counts(flash, paged)
    del dparams, static
    torch.cuda.empty_cache()
    self_draft = ("llama3_8b", cfg, params, SPEC_K)
    eng = ContinuousBatchingEngine("llama3_8b", cfg, params, slots=4,
                                   max_len=DENSE_MAX_LEN, draft=self_draft,
                                   device="cuda")
    try:
        _zero(flash, paged)
        _, aouts, awall = _run_engine_mix(eng, rows, DENSE_NEW_TOKENS)
        self_counts = _counts(flash, paged)
        astats = eng.stats()
    finally:
        eng.stop()
    _zero(flash, paged)
    t0 = time.perf_counter()
    static = _Engine("llama3_8b", cfg, params, draft=self_draft,
                     device="cuda")
    atouts = static.generate(rows, DENSE_NEW_TOKENS)
    torch.cuda.synchronize()
    aswall = time.perf_counter() - t0
    self_static_counts = _counts(flash, paged)
    del static
    torch.cuda.empty_cache()
    if not (astats["spec_tokens_accepted_rate"] or 0) > 0.5:
        fail(f"self-draft speculation accepted "
             f"{astats['spec_tokens_accepted_rate']} of its proposals "
             f"(want > 0.5): the accepted-token path barely ran")
    diverged, shares = 0, []
    for label, outs in (("spec dense engine", souts),
                        ("spec static engine", touts),
                        ("self-draft dense engine", aouts),
                        ("self-draft static engine", atouts)):
        _check_outs(label, rows, outs, DENSE_NEW_TOKENS, cfg.vocab_size)
        for i, row, out in zip(idx, rows, outs):
            j, share = near_tie_check(torch, llama, cfg, params,
                                      f"{label} row {i}", row, out, want[i])
            diverged += j is not None
            shares.append(share)
    runs = (("engine", engine_counts), ("static", static_counts),
            ("self-draft engine", self_counts),
            ("self-draft static", self_static_counts))
    for label, c in runs:
        if c["flash_fwd"] <= 0:
            fail(f"speculation ({label}) never launched the flash forward")
    print(f"c. speculation llama3_8b + llama3_draft_200m k={SPEC_K}: "
          f"dense engine wall_s={wall:.3f} rounds={stats['spec_rounds']} "
          f"tokens_per_round={stats['spec_tokens_per_round']} "
          f"acceptance_rate={stats['spec_tokens_accepted_rate']} "
          f"step_ms_median={stats['decode_step_ms_median']:.3f}; static "
          f"wall_s={swall:.3f}; self-draft (llama3_8b k={SPEC_K}) dense "
          f"engine wall_s={awall:.3f} rounds={astats['spec_rounds']} "
          f"tokens_per_round={astats['spec_tokens_per_round']} "
          f"acceptance_rate={astats['spec_tokens_accepted_rate']} "
          f"step_ms_median={astats['decode_step_ms_median']:.3f}, static "
          f"wall_s={aswall:.3f}; rows equal to the plain greedy tokens "
          f"{4 * len(rows) - diverged}/{4 * len(rows)} (the rest first "
          f"diverge at a near-tie: NEAR_TIE_ULPS={NEAR_TIE_ULPS}, near-tie "
          f"share of positions {min(shares):.3f}-{max(shares):.3f}); every "
          f"token the target's greedy choice given its prefix, up to "
          f"near-ties; launches {dict(runs)}; random weights: the "
          f"acceptance rates say nothing of speed; phase_s="
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    return {k: sum(c[k] for _, c in runs) for k in engine_counts}


def int8_serving(torch, llama, flash, paged, cfg, params, prompts,
                 paged_stats):
    """Phase d: llama3_8b quantized to int8, served by the paged engine;
    first-admission logits against bf16's."""
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.quantize import quantize_tree, tree_bytes

    t_phase = time.perf_counter()
    full = tree_bytes(params)
    qparams = quantize_tree(params)
    torch.cuda.synchronize()
    qbytes = tree_bytes(qparams)
    eng = ContinuousBatchingEngine("llama3_8b", cfg, qparams, slots=8,
                                   kv="paged", page_size=16, device="cuda")
    try:
        _zero(flash, paged)
        _, outs, wall = _run_engine_mix(eng, prompts, DENSE_NEW_TOKENS)
        counts = _counts(flash, paged)
        stats = eng.stats()
        bad = eng.check_invariants()
    finally:
        eng.stop()
    if bad:
        fail(f"int8 engine: page pool invariants broken: {bad[:5]}")
    _check_outs("int8 engine", prompts, outs, DENSE_NEW_TOKENS,
                cfg.vocab_size)
    for kernel in SERVING_KERNELS:
        if counts[kernel] <= 0:
            fail(f"the int8 engine never launched {kernel}")
    prompt = prompts[0]
    page = 16
    n_pages = -(-len(prompt) // page) + 1
    tables = torch.full((1, n_pages), -1, dtype=torch.long, device="cuda")
    tables[0, :n_pages - 1] = torch.arange(1, n_pages, device="cuda")
    row = torch.tensor([prompt[:-1]], dtype=torch.long, device="cuda")
    tok = torch.tensor([prompt[-1]], dtype=torch.long, device="cuda")
    pos = torch.tensor([len(prompt) - 1], dtype=torch.long, device="cuda")
    logits = {}
    for name, p in (("bf16", params), ("int8", qparams)):
        cache = llama.paged_init_cache(cfg, n_pages, page, device="cuda")
        k, v = llama.paged_prefill_kv(cfg, p, row)
        llama.paged_insert_prefill(cache, k, v, tables[0], page)
        logits[name] = llama.decode_step_paged(cfg, p, cache, tok, pos,
                                               tables)[0][0]
        del cache, k, v
    rel = _rel(logits["int8"], logits["bf16"])
    if not torch.isfinite(logits["int8"]).all() or rel > INT8_REL_TOL:
        fail(f"int8 first admission vs bf16: relative max err {rel} "
             f"(tol {INT8_REL_TOL})")
    tokens = sum(len(o) for o in outs)
    print(f"d. int8 llama3_8b: weights {full / 2**30:.2f} GiB bf16 -> "
          f"{qbytes / 2**30:.2f} GiB int8; paged engine requests="
          f"{len(prompts)} tokens={tokens} wall_s={wall:.3f} "
          f"tokens_per_s={tokens / wall:.1f} decode_step_ms_median int8="
          f"{stats['decode_step_ms_median']:.3f} bf16 (phase 2)="
          f"{paged_stats['decode_step_ms_median']:.3f}; first admission "
          f"vs bf16 rel err {rel:.3e} (tol {INT8_REL_TOL}) same_argmax="
          f"{bool(logits['int8'].argmax() == logits['bf16'].argmax())}; "
          f"launches={counts}; phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    del qparams
    torch.cuda.empty_cache()
    return counts


# Phase e's pool is run full on purpose. Admission reserves a prompt's
# pages and decode takes more as it goes, so every prompt here is one
# token past a page boundary and asks for LANE_NEW tokens: no request
# needs a page after admission, and no row can run the pool dry
# mid-generation whatever the timing. KV pages hold four long requests
# and a little more, so interactive arrivals must preempt.
LANE_BURST = 6           # long best-effort prompts
LANE_PROMPT = 1505
LANE_NEW = 16
LANE_INTERACTIVE = 3
LANE_KV_PAGES = 400
LANE_BATCH_PROMPT = 193
LANE_INTERACTIVE_PROMPT = 289


def lanes_classes(torch, llama, flash, paged, cfg, params):
    """Phase e: prefill lanes, request classes and preemption over the
    paged llama3_8b engine. A burst of long best-effort requests holds
    the pool (only best-effort is preemptible in the catalog), then
    interactive requests arrive and must preempt."""
    import numpy as np

    from polyaxon_tpu_torch.obs.analyze import request_phases
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 5)
    burst = [rng.integers(0, cfg.vocab_size, LANE_PROMPT).tolist()
             for _ in range(LANE_BURST)]
    batch_rows = [rng.integers(0, cfg.vocab_size, LANE_BATCH_PROMPT).tolist()
                  for _ in range(2)]
    inter = [rng.integers(0, cfg.vocab_size,
                          LANE_INTERACTIVE_PROMPT).tolist()
             for _ in range(LANE_INTERACTIVE)]
    eng = ContinuousBatchingEngine(
        "llama3_8b", cfg, params, slots=4, kv="paged", page_size=16,
        kv_pages=LANE_KV_PAGES, prefill_slots=2, prefill_chunk=256,
        max_len=DENSE_MAX_LEN, device="cuda")
    try:
        _zero(flash, paged)
        be = [eng.submit(p, LANE_NEW, klass="best-effort") for p in burst]
        ba = [eng.submit(p, LANE_NEW, klass="batch") for p in batch_rows]
        deadline = time.monotonic() + 300
        while (eng.health()["decode_active"] < 3
               and time.monotonic() < deadline):
            time.sleep(0.01)
        ia = [eng.submit(p, LANE_NEW, klass="interactive") for p in inter]
        outs = {"best-effort": [r.wait(timeout=900) for r in be],
                "batch": [r.wait(timeout=900) for r in ba],
                "interactive": [r.wait(timeout=900) for r in ia]}
        counts = _counts(flash, paged)
        stats = eng.stats()
        bad = eng.check_invariants() + eng._pool.check_invariants()
        ttft = {}
        for reqs in (be, ba, ia):
            for r in reqs:
                summary = request_phases(eng.request_timeline(r.id))
                ttft.setdefault(r.klass, []).append(summary["ttft_ms"])
        victim = next((r for r in be if r.preemptions), None)
    finally:
        eng.stop()
    if bad:
        fail(f"lanes: invariants broken: {bad[:5]}")
    for klass, rows in (("best-effort", burst), ("batch", batch_rows),
                        ("interactive", inter)):
        _check_outs(f"lanes {klass}", rows, outs[klass], LANE_NEW,
                    cfg.vocab_size)
    if stats["handoffs"] <= 0:
        fail("lanes: no prefill-lane handoff happened")
    if sum(stats["preemptions"].values()) <= 0 or victim is None:
        fail(f"lanes: no preemption fired: {stats['preemptions']}")
    if counts["paged_decode"] <= 0:
        fail("lanes: the paged decode kernel never launched")
    # The preempted request against its solo run.
    solo = ContinuousBatchingEngine("llama3_8b", cfg, params, slots=1,
                                    kv="paged", page_size=16,
                                    max_len=DENSE_MAX_LEN, device="cuda")
    try:
        want = solo.submit(victim.tokens, LANE_NEW).wait(timeout=900)
    finally:
        solo.stop()
    near_tie_check(torch, llama, cfg, params, "preempted request",
                   victim.tokens, victim.out, want)
    per_class = {k: (f"median={float(np.median(v)):.1f}ms "
                     f"max={max(v):.1f}ms n={len(v)}")
                 for k, v in ttft.items()}
    print(f"e. lanes/classes/preemption llama3_8b: handoffs="
          f"{stats['handoffs']} handoff_pages={stats['handoff_pages']} "
          f"preemptions={stats['preemptions']} readmit_suffix_tokens="
          f"{stats['readmit_suffix_tokens']} victim_preemptions="
          f"{victim.preemptions}; TTFT {per_class}; launches={counts}; "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return counts


def _sse(url, payload):
    req = urllib.request.Request(
        url + "/v1/generate", method="POST",
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    events, name = [], None
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                events.append((name or "token",
                               json.loads(line[len("data: "):])))
                name = None
    return events


def _post_json(url, payload):
    req = urllib.request.Request(
        url + "/v1/generate", method="POST",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.load(resp)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.load(resp)


def _bound_http(engine):
    """The server's HTTP front (its handler and routes) over a fleet
    built here: ``ServingServer`` builds one engine, and a fleet has no
    server entry of its own."""
    from http.server import ThreadingHTTPServer

    from polyaxon_tpu_torch.serving.server import _Handler

    handler = type("BoundHandler", (_Handler,), {"engine": engine})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def http_defaults(torch, flash, paged):
    """Phase f: ``ServingServer("llama3_8b")`` with no engine arguments
    serves static/dense; a streamed answer equals the non-streamed one;
    a continuous engine's request timeline has the reference's span
    names."""
    from polyaxon_tpu_torch.serving.server import ServingServer, _Engine

    t_phase = time.perf_counter()
    body = {"tokens": [[11, 12, 13, 14] * 16], "max_new_tokens": 16}
    _zero(flash, paged)
    with ServingServer("llama3_8b", seed=SEED) as srv:
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t_phase
        if not isinstance(srv.engine, _Engine):
            fail(f"ServingServer defaults built {type(srv.engine)}")
        stats = _get_json(srv.url + "/v1/stats")
        plain = _post_json(srv.url, body)["tokens"]
        events = _sse(srv.url, body)
        alerts = alerts_endpoint(srv.url)
    static_counts = _counts(flash, paged)
    done = [p for n, p in events if n == "done"]
    streamed = [p["token"] for n, p in events if n == "token"]
    if stats["engine"] != "static" or not done or \
            done[0]["tokens"] != plain or streamed != plain[0] or \
            len(plain[0]) != 16:
        fail(f"HTTP defaults: stats {stats}, plain {plain}, "
             f"streamed {streamed}, done {done}")
    with ServingServer("llama3_8b", seed=SEED, batching="continuous",
                       kv="dense", slots=2) as srv:
        _zero(flash, paged)
        events = _sse(srv.url, dict(body, **{"class": "interactive"}))
        cont_counts = _counts(flash, paged)
        (rid,) = [p for n, p in events if n == "done"][0]["request_ids"]
        timeline = _get_json(f"{srv.url}/requests/{rid}/timeline")
    names = {c["name"] for c in timeline["spans"][0]["children"]}
    names.add(timeline["spans"][0]["name"])
    want = {"request", "queue_wait", "prefill", "decode"}
    if not want <= names or timeline["summary"]["ttft_ms"] is None:
        fail(f"HTTP timeline spans {sorted(names)} lack {sorted(want)}")
    print(f"f. HTTP defaults: ServingServer('llama3_8b') built the static "
          f"engine (dense) in {t_load:.1f}s; streamed == non-streamed "
          f"({len(streamed)} tokens); continuous timeline spans "
          f"{sorted(names)} ttft_ms={timeline['summary']['ttft_ms']:.1f}; "
          f"launches static={static_counts} continuous={cont_counts}; "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    print(f"16c. GET /alerts on phase f's server: {alerts}", flush=True)
    return {k: static_counts[k] + cont_counts[k] for k in static_counts}


def alerts_endpoint(url: str) -> str:
    """``GET /alerts`` must answer 200 with the committed rules; returns
    what it printed about them."""
    from polyaxon_tpu_torch.obs import rules as obs_rules

    t0 = time.perf_counter()
    with urllib.request.urlopen(url + "/alerts", timeout=60) as resp:
        code, body = resp.status, json.load(resp)
    ms = 1e3 * (time.perf_counter() - t0)
    want = sorted(r.id for r in obs_rules.load_ruleset())
    got = sorted(r["rule"] for r in body.get("rules", []))
    if code != 200 or got != want or len(want) != 18:
        fail(f"GET /alerts answered {code} with rules {got}, want the "
             f"18 committed {want}")
    return (f"200 in {ms:.1f} ms, {len(got)} rules, firing "
            f"{[a['rule'] for a in body['alerts']]}, states "
            f"{sorted({r['state'] for r in body['rules']})}")


def mistral_ring(torch, llama, flash, paged):
    """Phase b: mistral_7b at full width and depth, one 4,000-token
    prompt and 256 new tokens over a 4,096-slot ring (so it wraps);
    the last decode step's logits against one windowed forward over the
    whole 4,256-token sequence, and the dense engine serving the same
    request."""
    import numpy as np

    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import load_params

    t_phase = time.perf_counter()
    cfg, params = load_params("mistral_7b", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t_phase
    max_len = MISTRAL_PROMPT + MISTRAL_NEW
    ring = llama.cache_len(cfg, max_len)
    if ring != cfg.sliding_window or ring >= max_len:
        fail(f"mistral: ring {ring} does not wrap within {max_len}")
    rng = np.random.default_rng(SEED + 7)
    prompt = rng.integers(0, cfg.vocab_size, MISTRAL_PROMPT).tolist()
    _zero(flash, paged)
    t0 = time.perf_counter()
    logits, cache = llama.prefill(cfg, params, torch.tensor(
        [prompt], dtype=torch.long, device="cuda"), max_len)
    toks = []
    for i in range(MISTRAL_NEW):
        tok = logits.argmax(dim=-1)
        toks.append(int(tok[0]))
        logits, cache = llama.decode_step(cfg, params, cache, tok,
                                          MISTRAL_PROMPT + i)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    fn_counts = _counts(flash, paged)
    del cache
    seq = prompt + toks
    full = _teacher_logits(torch, llama, cfg, params, prompt,
                           toks + [0])[-1]
    rel = _rel(logits[0], full)
    if not torch.isfinite(logits).all() or rel > MODEL_REL_TOL:
        fail(f"mistral: last decode-step logits vs the windowed forward "
             f"over {len(seq)} tokens: relative max err {rel} "
             f"(tol {MODEL_REL_TOL})")
    eng = ContinuousBatchingEngine("mistral_7b", cfg, params, slots=1,
                                   max_len=max_len, device="cuda")
    try:
        _zero(flash, paged)
        _, outs, wall = _run_engine_mix(eng, [prompt], MISTRAL_NEW)
        eng_counts = _counts(flash, paged)
        stats = eng.stats()
    finally:
        eng.stop()
    _check_outs("mistral engine", [prompt], outs, MISTRAL_NEW,
                cfg.vocab_size)
    near_tie_check(torch, llama, cfg, params, "mistral engine", prompt,
                   outs[0], toks)
    for label, c in (("function", fn_counts), ("engine", eng_counts)):
        if c["flash_fwd"] <= 0:
            fail(f"mistral ({label}) never launched the flash forward")
    print(f"b. mistral_7b ring: loaded in {t_load:.1f}s; prompt "
          f"{MISTRAL_PROMPT} + {MISTRAL_NEW} new over a {ring}-slot ring; "
          f"last decode-step logits vs windowed forward ({len(seq)} tokens) "
          f"rel err {rel:.3e}; prefill+decode loop {loop_s:.2f}s; engine "
          f"wall_s={wall:.3f} decode_step_ms_median="
          f"{stats['decode_step_ms_median']:.3f}; launches function="
          f"{fn_counts} engine={eng_counts}; phase_s="
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    del params
    torch.cuda.empty_cache()
    return {k: fn_counts[k] + eng_counts[k] for k in fn_counts}


def fleet(torch, flash, paged):
    """Phase g: two llama3_1b replicas behind the fleet router on the
    card; 16 requests, 8 sharing a 256-token prefix."""
    import numpy as np

    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.obs import metrics as obs_metrics
    from polyaxon_tpu_torch.serving.fleet import ServingFleet, engine_factory
    from polyaxon_tpu_torch.serving.router import FleetRouter

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    vocab = llama.CONFIGS["llama3_1b"].vocab_size
    prefix = rng.integers(0, vocab, 256).tolist()
    shared = [prefix + rng.integers(0, vocab, n).tolist()
              for n in (5, 40, 90, 130, 17, 64, 200, 8)]
    other = [rng.integers(0, vocab, n).tolist()
             for n in (300, 77, 512, 45, 260, 128, 600, 33)]
    reg = obs_metrics.MetricsRegistry()
    fl = ServingFleet(
        engine_factory("llama3_1b", slots=4, kv="paged", page_size=16,
                       max_len=4096, device="cuda"),
        replicas=2, standby=0, max_replicas=2, prewarm=False,
        router=FleetRouter(seed=SEED), registry=reg)
    fl.start()
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t_phase
    httpd = None
    try:
        _zero(flash, paged)
        t0 = time.perf_counter()
        order = [x for pair in zip(shared, other) for x in pair]
        reqs = [fl.submit(p, DENSE_NEW_TOKENS) for p in order]
        outs = [r.wait(timeout=900) for r, _ in reqs]
        wall = time.perf_counter() - t0
        counts = _counts(flash, paged)
        httpd, thread, url = _bound_http(fl)
        snap = _get_json(url + "/v1/fleet")
        stats = fl.stats()
        scaled = scale_from_alerts(fl, reg)
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        fl.stop()
    _check_outs("fleet", order, outs, DENSE_NEW_TOKENS, vocab)
    decisions = [d for _, d in reqs]
    shared_homes = {d.replica for p, d in zip(order, decisions)
                    if p[:256] == prefix}
    served = {d.replica for d in decisions}
    if len(shared_homes) != 1:
        fail(f"fleet: the shared prefix went to {shared_homes}")
    if served != {"r0", "r1"}:
        fail(f"fleet: only {served} served")
    if set(snap["per_replica"]) != {"r0", "r1"} or \
            snap["components"] != ["r0", "r1"]:
        fail(f"fleet: /v1/fleet lacks per-replica series: {snap}")
    if stats["kv_invariant_violations"]:
        fail("fleet: page pool invariants broken")
    for kernel in SERVING_KERNELS:
        if counts[kernel] <= 0:
            fail(f"fleet never launched {kernel}")
    tokens = sum(map(len, outs))
    reasons = {}
    for d in decisions:
        reasons[d.reason] = reasons.get(d.reason, 0) + 1
    print(f"g. fleet 2 x llama3_1b: built in {t_start:.1f}s; requests="
          f"{len(order)} tokens={tokens} wall_s={wall:.3f} "
          f"tokens_per_s={tokens / wall:.1f}; shared prefix on "
          f"{shared_homes.pop()}, served by {sorted(served)}, reasons "
          f"{reasons}; prefix_hit_rate={stats['prefix_hit_rate']}; "
          f"per_replica={snap['per_replica']}; launches={counts}; "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    print(f"16c. fleet autoscaler: {scaled}", flush=True)
    torch.cuda.empty_cache()
    return counts


def scale_from_alerts(fl, registry) -> str:
    """One autoscaler step fed from the committed rules: an alert engine
    over the fleet's registry evaluates them once, and ``maybe_scale``
    takes its firing rule ids; returns what it printed about it."""
    from polyaxon_tpu_torch.obs import rules as obs_rules
    from polyaxon_tpu_torch.serving.fleet import SCALE_UP_RULES

    rules = obs_rules.load_ruleset()
    if not SCALE_UP_RULES <= {r.id for r in rules}:
        fail(f"fleet: scale-up rules {sorted(SCALE_UP_RULES)} are not all "
             f"committed")
    fl.poll()
    engine = obs_rules.AlertEngine(rules, registry=registry)
    t0 = time.perf_counter()
    engine.evaluate()
    eval_ms = 1e3 * (time.perf_counter() - t0)
    firing = sorted(a["rule"] for a in engine.active())
    event = fl.maybe_scale(firing)
    return (f"{len(rules)} rules evaluated over the fleet's registry in "
            f"{eval_ms:.1f} ms, firing {firing}; maybe_scale({firing}) -> "
            f"{event}; states {fl.stats()['states']}")


def release(torch) -> None:
    """Free the device memory of a finished phase's engines: an engine
    sits in reference cycles (its threads and callbacks), so its weights
    go only when the cyclic collector runs."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def serve_the_rest(torch, llama, flash, paged, cfg, params, prompts,
                   paged_stats) -> tuple:
    """Phases a, c, e, f and d over phase 2's llama3_8b weights; returns
    each phase's launch counts."""
    dense_counts, dense_outs = dense_static(torch, llama, flash, paged, cfg,
                                            params, prompts, paged_stats)
    release(torch)
    spec_counts = speculation(torch, llama, flash, paged, cfg, params,
                              prompts, dense_outs)
    lane_counts = lanes_classes(torch, llama, flash, paged, cfg, params)
    release(torch)
    http_counts = http_defaults(torch, flash, paged)
    release(torch)
    int8_counts = int8_serving(torch, llama, flash, paged, cfg, params,
                               prompts, paged_stats)
    return dense_counts, spec_counts, lane_counts, http_counts, int8_counts


def run_training(torch, flash, paged, job, layers):
    """One training main path; returns its launch counts and the loss of
    each emitted step."""
    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    rt = job["runtime"]
    steps, accum = rt["steps"], rt["grad_accum_steps"]
    emitted = []
    torch.cuda.reset_peak_memory_stats()
    _zero(flash, paged)
    t0 = time.perf_counter()
    result = run_torchjob(job, on_metrics=lambda s, v: emitted.append((s, v)))
    wall = time.perf_counter() - t0
    counts = _counts(flash, paged)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for step, vals in emitted:
        print(f"train {rt['model']} step {step}: loss={vals['loss']:.5f} "
              f"grad_norm={vals['grad_norm']:.5f} "
              f"step_ms={vals['step_time_ms']:.1f} "
              f"tokens_per_s={vals['tokens_per_sec']:.1f} "
              f"mfu={vals.get('mfu', float('nan')):.4f}", flush=True)
    if len(emitted) != steps - 1 or result.steps != steps:
        fail(f"{rt['model']} training ran {result.steps} steps with "
             f"{len(emitted)} emissions")
    for step, vals in emitted:
        if not (math.isfinite(vals["loss"])
                and math.isfinite(vals["grad_norm"])):
            fail(f"{rt['model']} training step {step}: non-finite loss or "
                 f"grad norm {vals}")
    # remat "dots" recomputes the forward kernel once in the backward.
    want_bwd = layers * accum * steps
    if counts != {"flash_fwd": 2 * want_bwd, "flash_bwd_dkdv": want_bwd,
                  "flash_bwd_dq": want_bwd, "paged_decode": 0}:
        fail(f"{rt['model']} training main path launches {counts}; each "
             f"backward kernel must run {want_bwd} times (layers x "
             f"microbatches x steps), the forward twice as often")
    last = emitted[-1][1]
    print(f"train {rt['model']}: steps={result.steps} tokens_per_step="
          f"{result.units_per_step} tokens_per_s={result.throughput:.1f} "
          f"step_ms={last['step_time_ms']:.1f} mfu={last.get('mfu')} "
          f"first_step_s={result.compile_time_s:.1f} wall_s={wall:.1f} "
          f"max_memory_allocated_GB={peak_gb:.2f} "
          f"final_loss={result.final_metrics['loss']:.5f} launches={counts}",
          flush=True)
    return counts, {step: vals["loss"] for step, vals in emitted}, result


def first_step_parity(torch, llama, flash):
    """Loss and three named gradients of one packed 1x4096 microbatch,
    through the kernel path (remat none and dots) against the plain path
    (einsum attention under remat full: every remat mode computes the
    same values, and "full" keeps the plain path's [S, S] f32
    intermediates to one layer at a time).

    Then the witness of where the gradient gap comes from: each backward
    call of a kernel run against ``flash_bwd_plain_bf16`` on the same
    inputs, and runs of the forward kernel with the plain backward
    (``flash_bwd_impl="xla"``), in f32 and with P and dS rounded to bf16
    as the kernels round them."""
    from polyaxon_tpu_torch.runtime.data import lm_packed_synthetic

    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        lm_packed_synthetic(1, seq_len=4096, vocab_size=128_256,
                            seed=SEED + 1)).items()}
    base = llama.CONFIGS["llama3_1b"]
    params = llama.init(base, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")["params"]
    for t in _leaves(params):
        t.requires_grad_(True)
    names = (("wq", 0), ("wk", 0), ("w_down", TRAIN_LAYERS - 1))

    def run(**overrides):
        cfg = dataclasses.replace(base, **overrides)
        loss, _, _ = llama.apply(cfg, {"params": params, "state": {}}, batch)
        loss.backward()
        grads = {f"{n}[{i}]": params["layers"][n].grad[i].float().clone()
                 for n, i in names}
        for t in _leaves(params):
            t.grad = None
        torch.cuda.synchronize()
        return loss.item(), grads

    def rel(got, want):
        return {k: ((g - want[k]).norm() / want[k].norm()).item()
                for k, g in got.items()}

    def show(rels):
        return " ".join(f"{k}={v:.3e}" for k, v in rels.items())

    ref_loss, ref = run(attention_impl="xla", remat="full")
    kernel = {}
    for remat in ("none", "dots"):
        loss, got = run(attention_impl="flash", remat=remat)
        kernel[remat] = got
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        for key, g in got.items():
            if not torch.isfinite(g).all():
                fail(f"first-step parity: non-finite grad {key} ({remat})")
        rels = rel(got, ref)
        print(f"first-step parity remat={remat}: loss kernel={loss:.6f} "
              f"plain={ref_loss:.6f} rel={loss_rel:.3e} grad rel "
              f"{show(rels)}", flush=True)
        if loss_rel > TRAIN_LOSS_REL_TOL or max(rels.values()) \
                > TRAIN_GRAD_REL_TOL:
            fail(f"first-step parity ({remat}): loss rel {loss_rel} (tol "
                 f"{TRAIN_LOSS_REL_TOL}), grad rel {rels} (tol "
                 f"{TRAIN_GRAD_REL_TOL})")

    # The witness of the gradient gap's cause. (1) Every backward call of
    # a kernel run is held, on its own inputs (the model's activations and
    # packed segments), against the plain backward with the kernels' bf16
    # roundings: a mis-masked tile shows here, before 16 layers of bf16
    # rounding blur it. (2) Runs with the forward kernel and a plain
    # backward, in f32 and with those roundings, split the model-level gap
    # between the forward and the backward.
    layer_errs = []
    kernel_bwd = flash.flash_bwd_cuda

    def held(*args, **kw):
        got = kernel_bwd(*args, **kw)
        want = flash_bwd_plain_bf16(*args, **kw)
        layer_errs.append([((g.float() - w.float()).abs().max()
                            / w.float().abs().max()).item()
                           for g, w in zip(got, want)])
        return got

    def swapped(name, fn, **overrides):
        real = getattr(flash, name)
        setattr(flash, name, fn)  # the name _FlashFn.backward calls
        try:
            return run(**overrides)[1]
        finally:
            setattr(flash, name, real)

    swapped("flash_bwd_cuda", held, attention_impl="flash", remat="none")
    bwd_f32 = run(attention_impl="flash", flash_bwd_impl="xla",
                  remat="none")[1]
    bwd_bf16 = swapped("flash_bwd_plain", flash_bwd_plain_bf16,
                       attention_impl="flash", flash_bwd_impl="xla",
                       remat="none")
    worst = [max(e[i] for e in layer_errs) for i in range(3)]
    print(f"parity witness, each of {len(layer_errs)} backward calls held "
          f"against the plain backward with P and dS in bf16, worst "
          f"max|err| / max|plain|: dq={worst[0]:.3e} dk={worst[1]:.3e} "
          f"dv={worst[2]:.3e}", flush=True)
    bwd_rel = rel(kernel["none"], bwd_f32)
    print(f"parity witness, grad rel: forward kernel + f32 plain backward "
          f"against the plain path: {show(rel(bwd_f32, ref))}; plain "
          f"backward with P and dS in bf16 against it in f32: "
          f"{show(rel(bwd_bf16, bwd_f32))}; kernel path against the f32 "
          f"plain backward: {show(bwd_rel)}", flush=True)
    if len(layer_errs) != TRAIN_LAYERS \
            or not max(worst) <= TRAIN_LAYER_BWD_TOL:
        fail(f"first-step parity: {len(layer_errs)} backward calls held, "
             f"worst relative error {worst} (tol {TRAIN_LAYER_BWD_TOL})")
    if not max(bwd_rel.values()) <= TRAIN_BWD_REL_TOL:
        fail(f"first-step parity: the kernel path's gradients differ from "
             f"the f32 plain backward's by {bwd_rel} (tol "
             f"{TRAIN_BWD_REL_TOL})")
    del params


# ------------------------------------------------------ checkpoint drill
# TRAIN_JOB with checkpoints every 2 steps, one kept in the store, saved
# asynchronously.
DRILL_CKPT = {"enabled": True, "intervalSteps": 2, "maxToKeep": 1,
              "asyncSave": True}
# Room the drill's files need on the disk at once, in units of one
# checkpoint's bytes: the store's step, the older step the spill's hard
# links keep after the store has pruned it (SPILL_KEEP = 2), and the step
# being written.
DRILL_FILE_STATES = 3
# The depth of the drill (phase 7) and of the compiled plan (phase 9),
# cut for phase 20's share of the script's time (llama3_1b's 16 layers
# took 170-180 s and 99 s of it); the width stays.
DRILL_LAYERS = 4
PLAN_LAYERS = 8
# The most disk the drill's files may take at once, whatever is free:
# machines that run this script may cap how far a job's disk use grows
# (at 45 GiB on some), and the builds and logs need a little of that.
DRILL_DISK_BUDGET = 44 * 2**30
# Host memory left free beside the launcher's page-locked snapshot
# buffer (one checkpoint).
DRILL_HOST_MARGIN = 10e9
# The launcher as a plan runs it. Its last stdout line is the process's
# kernel launch counts (``runtime/launch.py``).
LAUNCHER = [sys.executable, "-m", "polyaxon_tpu_torch.runtime.launch"]
# The tolerance on a resumed loss when two uninterrupted runs differ:
# this many times their largest difference (the resumed run is one more
# sample of the same spread).
DRILL_SPREAD_FACTOR = 3.0
SERVE_NEW_TOKENS = 16


def _store_steps(ckdir: str) -> list[int]:
    try:
        return sorted(int(n) for n in os.listdir(ckdir) if n.isdigit())
    except OSError:
        return []


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as fh:
            return fh.read()[-n:]
    except OSError:
        return ""


def _json_lines(path: str) -> list[dict]:
    out = []
    with open(path, errors="replace") as fh:
        for line in fh:
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out


def fit_depth(torch, llama, free_disk: float, free_host: float,
              file_states: int, label: str, model: str = "llama3_1b",
              host_states: int = 1, cap: int = 0):
    """``model``'s depth for a phase that keeps ``file_states``
    checkpoints on the disk at once: its full depth or ``cap`` layers,
    cut further only if those do not fit in the free disk or in
    DRILL_DISK_BUDGET, or ``host_states`` host copies of one (the
    launcher's snapshot; an in-process sweep's tier-0 replicas) do not
    fit in the host's available memory less DRILL_HOST_MARGIN (a cut is
    printed). Returns (layers, checkpoint bytes)."""
    cfg = llama.CONFIGS[model]
    full = cfg.n_layers
    meta = llama.init(cfg, torch.Generator(), device="meta")["params"]
    per_layer = sum(t.numel() for t in meta["layers"].values()) \
        // cfg.n_layers
    other = sum(t.numel() for t in _leaves(meta)) - per_layer * cfg.n_layers

    def state_bytes(layers):  # f32 params, adamw mu and nu
        return 12 * (other + per_layer * layers)

    def fits(layers):
        files = file_states * state_bytes(layers)
        return (files <= min(free_disk, DRILL_DISK_BUDGET)
                and host_states * state_bytes(layers)
                <= free_host - DRILL_HOST_MARGIN)

    layers = min(full, cap) if cap else full
    if layers < full:
        print(f"{label}: {model}'s depth cut from {full} to {layers} "
              f"layers for phase 20's time, width kept", flush=True)
    top = layers
    while layers > 1 and not fits(layers):
        layers -= 1
    if layers < top:
        print(f"{label}: {file_states} checkpoints of "
              f"{state_bytes(top) / 1e9:.2f} GB do not fit in "
              f"{min(free_disk, DRILL_DISK_BUDGET) / 1e9:.1f} GB of disk "
              f"({free_disk / 1e9:.1f} GB free, budget "
              f"{DRILL_DISK_BUDGET / 1e9:.1f} GB), or {host_states} in "
              f"{free_host / 1e9:.1f} GB of host memory: {model}'s depth "
              f"cut from {top} to {layers} layers, width kept", flush=True)
    return layers, state_bytes(layers)


def drill_job(torch, llama, free_disk: float, free_host: float):
    """The drill's job and its depth: TRAIN_JOB with DRILL_CKPT at full
    width, at ``fit_depth``'s depth (at most DRILL_LAYERS) for
    DRILL_FILE_STATES checkpoints.
    Returns (job, layers, checkpoint bytes)."""
    layers, nbytes = fit_depth(torch, llama, free_disk, free_host,
                               DRILL_FILE_STATES, "checkpoint drill",
                               cap=DRILL_LAYERS)
    job = json.loads(json.dumps(TRAIN_JOB))
    job["checkpointing"] = dict(DRILL_CKPT)
    if layers < TRAIN_LAYERS:
        job["runtime"]["n_layers"] = layers
    return job, layers, nbytes


def device_crcs(torch, state) -> list[int]:
    """CRC-32 of each leaf's bytes, copied off the card through one
    page-locked buffer (scalars as the int64 the store keeps)."""
    import zlib

    import numpy as np
    from polyaxon_tpu_torch.runtime import checkpoint as ck

    buf = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    out = []
    for _, leaf in ck.flatten(state):
        if not isinstance(leaf, torch.Tensor):
            out.append(ck.crc32(np.asarray(leaf, np.int64)))
            continue
        flat, crc = leaf.detach().reshape(-1).view(torch.uint8), 0
        for off in range(0, flat.numel(), buf.numel()):
            m = min(buf.numel(), flat.numel() - off)
            buf[:m].copy_(flat[off:off + m])
            crc = zlib.crc32(buf.numpy()[:m], crc)
        out.append(crc)
    return out


def restore_checked(torch, llama, job, ckdir: str, label: str):
    """Restore the newest committed step of ``job``'s checkpoints in this
    process, into a state initialised from another seed, and hold each
    leaf's CRC-32 against the manifest. Returns (the manager, the state,
    the step, the CRC-32s, the tier the restore came from); the caller
    closes the manager."""
    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.runtime import checkpoint as ck
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.optim import build_optimizer
    from polyaxon_tpu_torch.runtime.step import build_init

    rcfg = RuntimeConfig.from_dict(job["runtime"])
    model_def = get_model(rcfg.model,
                          **rcfg.model_overrides(llama.LlamaConfig))
    state = build_init(model_def, build_optimizer(rcfg),
                       device="cuda")(SEED + 1)
    mgr = ck.TieredCheckpointManager(
        ckdir, ck.CheckpointSpec.from_dict(job["checkpointing"]))
    try:
        state = mgr.restore(state)
        tier = mgr.last_restore_tier
        step = mgr.latest_step()
        manifest = ck.read_manifest(ckdir, step)
        got = device_crcs(torch, state)
        want = [e["crc32"] for e in manifest["leaves"]]
        if got != want or state["step"] != TRAIN_STEPS:
            bad = [e["path"] for e, g in zip(manifest["leaves"], got)
                   if e["crc32"] != g]
            fail(f"{label}: restored step {state['step']}; leaves that "
                 f"differ from the manifest of step {step}: {bad[:5]}")
    except BaseException:
        mgr.close()
        raise
    return mgr, state, step, want, tier


def checkpoint_drill(torch, flash, paged, llama, train_losses,
                     train_result):
    """The launcher checkpoints llama3_1b's training, is SIGKILLed once
    the store lists a committed step, and is started again on the same
    directory: it must resume from that step and finish. Then the
    resumed losses, the restored bytes and the tracking record are held,
    the checkpoint is served, and a save and restore in this process
    time tier 0. Returns the launch counts of the resumed run and of the
    serving engine."""
    import shutil
    import signal

    from polyaxon_tpu_torch.runtime import tiers
    from polyaxon_tpu_torch.tracking import events

    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-drill-")
    try:
        return _drill(torch, flash, paged, llama, train_losses, train_result,
                      tmp, repo, tiers, events, signal)
    finally:
        tiers.TIER0.clear()
        shutil.rmtree(tmp, ignore_errors=True)


def _drill(torch, flash, paged, llama, train_losses, train_result, tmp,
           repo, tiers, events, signal):
    import shutil

    from polyaxon_tpu_torch.tracking.systemmetrics import meminfo

    free_disk = shutil.disk_usage(tmp).free
    free_host = meminfo()["MemAvailable"]
    job, layers, nbytes = drill_job(torch, llama, free_disk, free_host)
    print(f"checkpoint drill: llama3_1b {layers} layers, "
          f"{nbytes / 1e9:.3f} GB per checkpoint (f32 params, adamw mu "
          f"and nu), files under {tmp} ({free_disk / 1e9:.1f} GB free "
          f"disk, budget {DRILL_DISK_BUDGET / 1e9:.1f} GB), "
          f"{free_host / 1e9:.1f} GB host memory available", flush=True)
    # Two uninterrupted runs measure the run-to-run spread of the loss
    # (the embedding's backward accumulates with atomics), at the drill's
    # depth.
    ref_job = dict(job, checkpointing={"enabled": False})
    refs, ref_result = [], train_result
    if layers == TRAIN_LAYERS:
        refs.append(train_losses)
    while len(refs) < 2:
        _, losses, ref_result = run_training(torch, flash, paged, ref_job,
                                             layers)
        refs.append(losses)
        torch.cuda.empty_cache()
    spread = max(abs(refs[0][s] - refs[1][s]) for s in refs[0])
    print(f"checkpoint drill: two uninterrupted runs differ by at most "
          f"{spread:.3e} in loss over steps {sorted(refs[0])}", flush=True)

    art = os.path.join(tmp, "run")
    ckdir = os.path.join(art, "checkpoints")
    env = dict(os.environ, POLYAXON_JAXJOB_SPEC=json.dumps(job),
               POLYAXON_RUN_ARTIFACTS_PATH=art, POLYAXON_RUN_UUID="drill")
    logs = {k: os.path.join(tmp, f"{k}.log") for k in
            ("first.out", "first.err", "second.out", "second.err")}

    # How far the disk's use grows while the launchers run, sampled.
    disk0, disk_peak = shutil.disk_usage(tmp).used, [0]
    watching = threading.Event()

    def watch_disk():
        while not watching.wait(0.2):
            disk_peak[0] = max(disk_peak[0],
                               shutil.disk_usage(tmp).used - disk0)

    watcher = threading.Thread(target=watch_disk, daemon=True)
    watcher.start()

    # 1. The first run, killed once a step is committed.
    t0 = time.perf_counter()
    with open(logs["first.out"], "w") as out, \
            open(logs["first.err"], "w") as err:
        proc = subprocess.Popen(LAUNCHER, cwd=repo, env=env, stdout=out,
                                stderr=err, start_new_session=True)
        try:
            while not _store_steps(ckdir):
                if proc.poll() is not None:
                    fail(f"checkpoint drill: the launcher exited "
                         f"({proc.returncode}) before a step was "
                         f"committed:\n{_tail(logs['first.err'])}")
                if time.perf_counter() - t0 > 600:
                    fail("checkpoint drill: no step committed in 600 s")
                time.sleep(0.02)
            committed = _store_steps(ckdir)
            os.killpg(proc.pid, signal.SIGKILL)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    t_kill = time.perf_counter() - t0
    left = sorted(os.listdir(ckdir))
    spill_left = sorted(os.listdir(os.path.join(ckdir, tiers.SPILL_DIRNAME))
                        ) if os.path.isdir(os.path.join(
                            ckdir, tiers.SPILL_DIRNAME)) else []
    first_losses = {r["step"]: r["loss"] for r in
                    _json_lines(logs["first.out"]) if "loss" in r}
    print(f"checkpoint drill: SIGKILL {t_kill:.1f}s after start, store "
          f"steps {committed}; left in the store {left}, in the spill "
          f"{spill_left}; losses before the kill {first_losses}",
          flush=True)

    # 2. The restart on the same directory.
    t0 = time.perf_counter()
    with open(logs["second.out"], "w") as out, \
            open(logs["second.err"], "w") as err:
        proc = subprocess.Popen(LAUNCHER, cwd=repo, env=env, stdout=out,
                                stderr=err, start_new_session=True)
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            fail("checkpoint drill: the restarted launcher ran over 900 s")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    t_second = time.perf_counter() - t0
    watching.set()
    watcher.join()
    print(f"checkpoint drill: the disk's use grew by at most "
          f"{disk_peak[0] / 1e9:.2f} GB while the launchers ran "
          f"({DRILL_FILE_STATES} checkpoints: "
          f"{DRILL_FILE_STATES * nbytes / 1e9:.2f} GB; budget "
          f"{DRILL_DISK_BUDGET / 1e9:.2f} GB)", flush=True)
    if rc != 0:
        fail(f"checkpoint drill: the restarted launcher exited {rc}:\n"
             f"{_tail(logs['second.err'])}")
    lines = _json_lines(logs["second.out"])
    outputs = next((r["outputs"] for r in lines if "outputs" in r), None)
    launches = next((r["launches"] for r in lines if "launches" in r), None)
    if outputs is None or launches is None:
        fail(f"checkpoint drill: no result from the restarted launcher:\n"
             f"{_tail(logs['second.out'])}")
    restored = outputs["restored_from_step"]
    if not (restored is not None and 2 <= restored < TRAIN_STEPS
            and outputs["restore_tier"] in (tiers.TIER_LOCAL,
                                            tiers.TIER_STORE)
            and outputs["steps"] == TRAIN_STEPS):
        fail(f"checkpoint drill: the restart restored step {restored} from "
             f"tier {outputs['restore_tier']} and reached step "
             f"{outputs['steps']} (want 2 <= step < {TRAIN_STEPS}, tier 1 or "
             f"2, {TRAIN_STEPS} steps)")
    want_bwd = layers * TRAIN_ACCUM * (TRAIN_STEPS - restored)
    if launches != {"flash_fwd": 2 * want_bwd, "flash_bwd_dkdv": want_bwd,
                    "flash_bwd_dq": want_bwd, "paged_decode": 0}:
        fail(f"checkpoint drill: the resumed run launched {launches}; each "
             f"backward kernel must run {want_bwd} times")

    # 3. The resumed losses against the uninterrupted runs.
    resumed = {r["step"]: r["loss"] for r in lines if "loss" in r}
    if sorted(resumed) != list(range(restored + 1, TRAIN_STEPS)):
        fail(f"checkpoint drill: the resumed run emitted steps "
             f"{sorted(resumed)}")
    tol = 0.0 if spread == 0.0 else DRILL_SPREAD_FACTOR * spread
    worst = 0.0
    for step, loss in {**first_losses, **resumed}.items():
        diff = abs(loss - refs[0][step])
        worst = max(worst, diff) if step in resumed else worst
        if diff > tol:
            fail(f"checkpoint drill: step {step} loss {loss!r} against the "
                 f"uninterrupted {refs[0][step]!r}: diff {diff:.3e} (tol "
                 f"{tol:.3e}: {'bitwise' if tol == 0 else 'run spread'})")
    print(f"checkpoint drill: restart restored step {restored} from tier "
          f"{outputs['restore_tier']} in "
          f"{outputs['checkpoint']['restore_s']} s (reference budget "
          f"{tiers.RESTORE_BUDGET_P99_SECONDS} s p99), ran to step "
          f"{outputs['steps']} in {t_second:.1f}s; resumed losses "
          f"{resumed}, max diff to the uninterrupted run {worst:.3e} (tol "
          f"{tol:.3e}, {'bitwise' if tol == 0 else 'run spread'}); "
          f"launches {launches}", flush=True)
    prep = [line.rsplit(" in ", 1)[-1].strip() for line in
            open(logs["second.err"], errors="replace")
            if "snapshot buffer ready" in line]
    print(f"checkpoint drill: the restarted launcher's snapshot buffer "
          f"(page locking) took {prep}", flush=True)
    cp = outputs["checkpoint"]
    stalls = [w + s for w, s in zip(cp["save_wait_s"], cp["snapshot_s"])]
    loop_stall = sum(stalls[:-1])  # the last is the final, forced save
    timed = round(outputs["throughput"] * outputs["wall_time"]
                  / outputs["units_per_step"])
    with_stall = (outputs["units_per_step"] * timed
                  / (outputs["wall_time"] + loop_stall)) if timed else 0.0
    # The steady state, which the resumed run's few steps cannot show: a
    # save every intervalSteps steps takes its snapshot, and waits for the
    # previous commit whenever that outlasts the steps between two saves.
    n_saves = len(cp["snapshot_s"])
    commits = [sum(v[k] for v in cp["commit_s"].values() if k < len(v))
               for k in range(n_saves)]
    t_between = (DRILL_CKPT["intervalSteps"] * outputs["units_per_step"]
                 / outputs["throughput"])
    t_commit = sum(commits) / n_saves
    t_snap = sum(cp["snapshot_s"]) / n_saves
    steady = t_between / (t_snap + max(t_between, t_commit))
    print(f"checkpoint drill: bytes={cp['bytes']} per checkpoint; per "
          f"save: wait_s={cp['save_wait_s']} snapshot_s={cp['snapshot_s']} "
          f"commit_s={commits} (by tier {cp['commit_s']}); publish_errors="
          f"{cp['publish_errors']}", flush=True)
    print(f"checkpoint drill: tokens_per_s over the resumed run's {timed} "
          f"timed steps: {outputs['throughput']:.1f} with the saves off the "
          f"clock, {with_stall:.1f} with the step loop's save stalls (the "
          f"final save's wait, {cp['save_wait_s'][-1]:.3f}s, falls after "
          f"the loop), uninterrupted {ref_result.throughput:.1f}; steady "
          f"state from the measured times (a save every "
          f"{t_between:.3f}s of steps, snapshot {t_snap:.3f}s, commit "
          f"{t_commit:.3f}s): {steady:.4f} of the uninterrupted rate, "
          f"{steady * ref_result.throughput:.1f} tokens/s", flush=True)
    if cp["publish_errors"]:
        fail("checkpoint drill: a checkpoint commit failed")

    # 5. The tracking record, through the port's own reader.
    loss_events = events.read_events(art, "metric", "loss")
    with open(os.path.join(art, "outputs.json")) as fh:
        tracked = json.load(fh)
    statuses = [r["status"] for r in events.read_jsonl(
        os.path.join(art, "statuses.jsonl"))]
    hbm = [r["value"] for r in events.read_events(art, "system",
                                                  "gpu0_hbm_used_gb")]
    if not (loss_events and tracked["steps"] == TRAIN_STEPS
            and tracked["restored_from_step"] == restored
            and statuses[-1] == "succeeded"
            and hbm and max(hbm) * 2**30 > nbytes):
        fail(f"checkpoint drill: tracking record: {len(loss_events)} loss "
             f"events, outputs steps {tracked.get('steps')} restored "
             f"{tracked.get('restored_from_step')}, statuses {statuses}, "
             f"gpu0_hbm_used_gb samples {hbm}")
    print(f"checkpoint drill: tracking record: {len(loss_events)} loss "
          f"events, outputs steps={tracked['steps']} restored_from_step="
          f"{tracked['restored_from_step']}, statuses {statuses}, "
          f"{len(hbm)} gpu0_hbm_used_gb samples (max {max(hbm):.2f} GiB), "
          f"system metrics {events.list_event_names(art, 'system')}",
          flush=True)

    # 4. The restored bytes, in this process, against the manifest.
    mgr, state, step, want, first_tier = restore_checked(
        torch, llama, job, ckdir, "checkpoint drill")
    try:
        state = mgr.restore(state, step=step)  # the store, explicitly
        print(f"checkpoint drill: restored step {step} here from tier "
              f"{first_tier}, then from the store; {len(want)} leaf "
              f"CRC-32s equal the manifest's", flush=True)

        serve_counts = serve_checkpoint(torch, flash, paged, llama, ckdir,
                                        layers)

        # 6. Tier 0, twice. First the replica the spill restore above
        # promoted (pageable host memory). Then a save's first half: the
        # snapshot into the page-locked buffer, published as the replica,
        # and its restore. The save's disk commits are the launcher's,
        # measured above; none is repeated here.
        def restore_from_memory(what):
            restored = mgr.restore(state)
            if mgr.last_restore_tier != tiers.TIER_MEMORY:
                fail(f"checkpoint drill: the restore of {what} came from "
                     f"tier {mgr.last_restore_tier}, not memory")
            if device_crcs(torch, restored) != want:
                fail(f"checkpoint drill: the restore of {what} changed the "
                     f"bytes")
            return restored

        state = restore_from_memory("the promoted replica")
        tiers.TIER0.drop(mgr.directory)
        t0 = time.perf_counter()
        mgr.prepare(state)
        t_prep = time.perf_counter() - t0
        t0 = time.perf_counter()
        arrays, snap_manifest = mgr._snapshot(step, state)
        t_snap = time.perf_counter() - t0
        t0 = time.perf_counter()
        tiers.TIER0.publish(mgr.directory, step,
                            {f"leaf_{i}": a for i, a in enumerate(arrays)},
                            snap_manifest)
        t_pub = time.perf_counter() - t0
        del arrays
        state = restore_from_memory("the snapshot")
        print(f"checkpoint drill: here, host buffer {t_prep:.2f}s (page "
              f"locking, once per manager); snapshot {t_snap:.3f}s; tier-0 "
              f"publish {t_pub:.6f}s; restore_s by tier "
              f"{mgr.restore_seconds} (tier 0: the promoted replica, then "
              f"the page-locked snapshot; reference budget "
              f"{tiers.RESTORE_BUDGET_P99_SECONDS} s p99)", flush=True)
    finally:
        mgr.close()
    del state
    torch.cuda.empty_cache()
    return launches, serve_counts


def serve_checkpoint(torch, flash, paged, llama, ckdir, layers):
    """The paged engine serves the drill's checkpoint: two requests of
    SERVE_NEW_TOKENS new tokens through the flash forward and paged
    decode (head_dim 64), then the first admission against the plain
    path. Returns the engine's launch counts."""
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import load_params

    import numpy as np

    name = "llama3_1b"
    if layers < TRAIN_LAYERS:  # a cut drill: serve the cut model
        name = f"llama3_1b_{layers}l"
        llama.CONFIGS[name] = dataclasses.replace(llama.CONFIGS["llama3_1b"],
                                                  n_layers=layers)
    t0 = time.perf_counter()
    cfg, params = load_params(name, checkpoint=ckdir, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in
               (700, 129)]
    eng = ContinuousBatchingEngine(name, cfg, params, slots=2, kv="paged",
                                   page_size=16, max_len=4096,
                                   device="cuda")
    try:
        _zero(flash, paged)
        reqs = [eng.submit(p, SERVE_NEW_TOKENS) for p in prompts]
        outs = [r.wait(timeout=600) for r in reqs]
        counts = _counts(flash, paged)
    finally:
        eng.stop()
    for o in outs:
        if len(o) != SERVE_NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in o):
            fail(f"serving the drill's checkpoint: malformed output {o}")
    for kernel in SERVING_KERNELS:
        if counts[kernel] <= 0:
            fail(f"serving the drill's checkpoint never launched {kernel}")
    print(f"serve checkpoint: {name} loaded in {t_load:.1f}s, "
          f"{len(prompts)} requests x {SERVE_NEW_TOKENS} new tokens, "
          f"launches {counts}", flush=True)
    compare_first_admission(torch, llama, cfg, params, prompts[1])
    del params
    torch.cuda.empty_cache()
    return counts


# --------------------------------------- Polyaxonfile → plan → launcher
PACKED_EXAMPLE = "examples/packed_pretrain.yaml"
GPU_PRESET = "tests/fixtures/presets/gpu.yaml"
# chip_smoke's own preset over the example: one process (the example's
# v5e 2x4 topology compiles to two, and the port trains on one card),
# phase 4's 6 steps of 4 microbatches, and a loss every step (phase 4's
# cadence, so that the two phases' tokens/s compare).
H100_PRESET = {"isPreset": True, "patchStrategy": "post_merge",
               "runPatch": {"numProcesses": 1, "runtime": {
                   "steps": TRAIN_STEPS, "grad_accum_steps": TRAIN_ACCUM,
                   "log_every": 1}}}
# The corpus: at least this many rows of the example's 4096 tokens (the
# bytes tokenizer: one token per byte), in documents of CORPUS_DOC_WORDS
# words drawn from a Zipf-like vocabulary of CORPUS_VOCAB random words.
CORPUS_ROWS = 1024
CORPUS_VOCAB = 20_000
CORPUS_DOC_WORDS = (20, 160)


def write_corpus(path: str, min_bytes: int, seed: int) -> tuple[int, int]:
    """A synthetic text corpus from ``seed``: documents of lowercase words
    separated by blank lines, at least ``min_bytes`` long. Returns (bytes,
    documents)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    vocab = np.array([letters[rng.integers(0, 26, n)].tobytes().decode()
                      for n in rng.integers(1, 11, CORPUS_VOCAB)])
    weights = 1.0 / np.arange(1, CORPUS_VOCAB + 1)
    cdf = np.cumsum(weights) / weights.sum()
    size = docs = 0
    with open(path, "w") as fh:
        while size < min_bytes:
            n = int(rng.integers(*CORPUS_DOC_WORDS))
            words = vocab[np.searchsorted(cdf, rng.random(n), side="right")]
            doc = " ".join(words) + "\n\n"
            fh.write(doc)
            size += len(doc)
            docs += 1
    return size, docs


def compiled_launch(torch, llama, train_result):
    """Phase 9: ``examples/packed_pretrain.yaml`` submitted to the port's
    ``ControlPlane`` (the gpu preset and H100_PRESET, a synthetic corpus
    from SEED) in a fresh home, and run by the port's ``Agent`` as a
    subprocess gang to SUCCEEDED. Checks the record's status history, the
    tracking record through ``plane.streams``, the `auth` init phase, the
    trace, the committed checkpoint and the kernels' launches (from the
    gang's log); prints the plane's timings and the numbers beside phase
    4's. Returns the process's launch counts."""
    import shutil
    import tempfile

    from polyaxon_tpu_torch.runtime import tiers

    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-plan-")
    try:
        return _compiled_launch(torch, llama, train_result, tmp)
    finally:
        tiers.TIER0.clear()
        shutil.rmtree(tmp, ignore_errors=True)


# The status history of a subprocess jaxjob that succeeds, as
# tests/test_torch_agent.py establishes it on the CPU.
SUBPROCESS_HISTORY = ["created", "compiled", "queued", "scheduled",
                      "starting", "running", "succeeded"]


def _iso_s(stamp: str) -> float:
    import datetime as dt

    return dt.datetime.fromisoformat(stamp).timestamp()


def _watch_exit(agent, run_uuid: str, out: dict, stop: threading.Event):
    """Record when the gang's process has exited (a zombie, or gone),
    before the agent's next poll reaps it: the process's own end, apart
    from the agent's poll interval; and the host's dirty page cache then
    (the checkpoint's bytes not yet written back)."""
    from polyaxon_tpu_torch.tracking.systemmetrics import meminfo

    pid = None
    while not stop.wait(0.005):
        gang = agent.executor._gangs.get(run_uuid)
        if pid is None and gang is not None and gang.procs:
            pid = gang.procs[0].pid
        if pid is None:
            continue
        try:
            with open(f"/proc/{pid}/stat") as fh:
                state = fh.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            state = "X"
        if state in ("Z", "X"):
            out["exit"] = time.time()
            out["dirty"] = meminfo().get("Dirty", 0)
            return


class _ReconcileClock:
    """Seconds spent in each of the agent's reconcile passes, in the
    executor's poll within it, and in Python's garbage collector while
    it ran: what the caller waits for between the run's SUCCEEDED
    condition and ``run_until_done``'s return."""

    def __init__(self, agent):
        import gc

        self.passes: list[tuple[float, float, float]] = []
        self._gc = self._gc_start = 0.0
        reconcile, poll = agent.reconcile_once, agent.executor.poll
        self._poll = 0.0

        def timed_poll():
            t0 = time.perf_counter()
            try:
                return poll()
            finally:
                self._poll += time.perf_counter() - t0

        def timed_reconcile():
            self._poll, gc0 = 0.0, self._gc
            t0 = time.perf_counter()
            try:
                return reconcile()
            finally:
                self.passes.append((time.perf_counter() - t0, self._poll,
                                    self._gc - gc0))

        def on_gc(phase, info):
            if phase == "start":
                self._gc_start = time.perf_counter()
            else:
                self._gc += time.perf_counter() - self._gc_start

        agent.executor.poll = timed_poll
        agent.reconcile_once = timed_reconcile
        gc.callbacks.append(on_gc)
        self._remove = lambda: gc.callbacks.remove(on_gc)

    def close(self) -> str:
        self._remove()
        total, poll, gc_s = self.passes[-1]
        return (f"{len(self.passes)} reconcile passes; the last (the reap) "
                f"{total:.3f}s, of which the executor's poll {poll:.3f}s "
                f"and garbage collection {gc_s:.3f}s; the slowest "
                f"{max(p[0] for p in self.passes):.3f}s; garbage collection "
                f"{self._gc:.3f}s in all")


class _PassClock:
    """Counts and times the agent's two telemetry passes
    (``_sample_history``, then ``_evaluate_alerts``) in each reconcile."""

    def __init__(self, agent):
        self.seconds: dict[str, list[float]] = {}
        for name in ("_sample_history", "_evaluate_alerts"):
            real = getattr(agent, name)

            def timed(real=real, name=name):
                t0 = time.perf_counter()
                try:
                    return real()
                finally:
                    self.seconds.setdefault(name, []).append(
                        time.perf_counter() - t0)

            setattr(agent, name, timed)

    def summary(self, name: str) -> str:
        times = self.seconds.get(name) or [float("nan")]
        return (f"{len(self.seconds.get(name, []))} passes, median "
                f"{1e3 * sorted(times)[len(times) // 2]:.3f} ms, max "
                f"{1e3 * max(times):.3f} ms")


def telemetry_plane(plane, run_uuid: str, passes: _PassClock) -> None:
    """Phase 16b on phase 9's SUCCEEDED run: ``plane.report`` closes its
    phase accounting within ``phase-accounting-closes``' tolerance,
    ``plane.verify`` judges all 16 invariants (four must pass), the
    agent ran both telemetry passes; prints the report, every verdict
    and the times."""
    from polyaxon_tpu_torch.obs import history as obs_history
    from polyaxon_tpu_torch.obs import oracle as obs_oracle

    label = "16b. plane"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    report = plane.report(run_uuid)
    report_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    result = plane.verify(run_uuid)
    verify_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    obs_history.default_history().sample(force=True)
    sample_ms = 1e3 * (time.perf_counter() - t0)

    (closes,) = [i for i in obs_oracle.load_invariants()
                 if i.id == "phase-accounting-closes"]
    wall, total = report["wall_clock_ms"], report["phase_sum_ms"]
    gap = abs(total - wall) / wall if wall else float("inf")
    phases = {n: f"{p['ms']:.1f} ms ({p['fraction']})"
              for n, p in report["phases"].items()}
    steps = report["steps"]
    print(f"{label}: report of run {run_uuid} in {report_ms:.1f} ms: "
          f"status {report['status']}, attempts {report['attempts']}, wall "
          f"{wall:.1f} ms, phases sum {total:.1f} ms (|gap|/wall "
          f"{gap:.4f}, tolerance {closes.tolerance}); phases {phases}; "
          f"step windows "
          f"{[(w['to_step'], w['step_time_ms']) for w in steps['windows']]}"
          f", rolling median {steps['rolling_median_ms']} ms, anomalies "
          f"{steps['anomalies']}; annotations {report['annotations']}; "
          f"alerts {report['alerts']}", flush=True)
    if gap > closes.tolerance:
        fail(f"{label}: the report's phases sum to {total:.1f} ms of a "
             f"{wall:.1f} ms wall clock")
    verdicts = {v["invariant"]: v for v in result["verdicts"]}
    if len(verdicts) != 16:
        fail(f"{label}: verify returned {len(verdicts)} verdicts: "
             f"{sorted(verdicts)}")
    for must in ("all-runs-terminal", "phase-accounting-closes",
                 "loss-continuity", "zero-unresolved-alerts"):
        if verdicts[must]["verdict"] != "pass":
            fail(f"{label}: {must} {verdicts[must]}")
    print(f"{label}: verify in {verify_ms:.1f} ms: passed="
          f"{result['passed']} counts={result['counts']}", flush=True)
    for name, v in verdicts.items():
        evidence = dict(v["evidence"])
        if "unresolved_alerts" in evidence:  # which rules, at what values
            evidence["unresolved_alerts"] = [
                (a["rule"], a.get("value"), a.get("threshold"))
                for a in evidence["unresolved_alerts"]]
        print(f"  {label} verdict {name}: {v['verdict']} "
              f"{json.dumps(evidence, default=str)[:400]}", flush=True)
    for name in ("_sample_history", "_evaluate_alerts"):
        if not passes.seconds.get(name):
            fail(f"{label}: the agent never ran {name}")
    print(f"{label}: agent history pass {passes.summary('_sample_history')}"
          f"; alert pass {passes.summary('_evaluate_alerts')}; one forced "
          f"history sample {sample_ms:.3f} ms; report {report_ms:.1f} ms, "
          f"verify {verify_ms:.1f} ms; phase_s="
          f"{time.perf_counter() - t_phase:.1f}", flush=True)


def _compiled_launch(torch, llama, train_result, tmp):
    import shutil

    from polyaxon_tpu_torch.agent import Agent
    from polyaxon_tpu_torch.compiler import ENV_JAXJOB_SPEC
    from polyaxon_tpu_torch.controlplane import ControlPlane
    from polyaxon_tpu_torch.lifecycle import V1Statuses, can_transition
    from polyaxon_tpu_torch.obs import metrics as obs_metrics
    from polyaxon_tpu_torch.obs import rules as obs_rules
    from polyaxon_tpu_torch.obs.trace import read_trace
    from polyaxon_tpu_torch.runtime.flops import (peak_flops,
                                                  train_flops_per_token)
    from polyaxon_tpu_torch.tracking import events
    from polyaxon_tpu_torch.tracking.systemmetrics import meminfo

    repo = os.path.dirname(os.path.abspath(__file__))
    label = "compiled plan"
    t_phase = time.perf_counter()

    # 1. The corpus, in this phase's own directory: the token caches are
    # written beside it.
    corpus = os.path.join(tmp, "corpus.txt")
    t0 = time.perf_counter()
    nbytes, ndocs = write_corpus(corpus, CORPUS_ROWS * 4096, SEED)
    print(f"{label}: corpus of {nbytes} bytes, {ndocs} documents, written "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)

    # The depth: PLAN_LAYERS unless one checkpoint (the final save; the
    # spill hard-links the store's files) does not fit, by the drill's
    # rule.
    layers, ckpt_bytes = fit_depth(torch, llama, shutil.disk_usage(tmp).free,
                                   meminfo()["MemAvailable"], 1, label,
                                   cap=PLAN_LAYERS)
    preset = json.loads(json.dumps(H100_PRESET))
    if layers < TRAIN_LAYERS:
        preset["runPatch"]["runtime"]["n_layers"] = layers

    # 2. Submitted to the port's plane, in a fresh home; the agent's
    # scheduler compiles it, its admission starts it as a subprocess gang
    # (the path a deployment takes) and its executor reaps it. The
    # process-global registry, its history ring and the alert engine
    # start empty, so phase 16b judges this run's telemetry alone, not
    # the earlier phases' serving traffic and restores.
    obs_metrics.REGISTRY.reset()
    obs_rules.set_default_engine(None)
    plane = ControlPlane(os.path.join(tmp, "home"))
    agent = Agent(plane)
    t_submit = time.time()
    record = plane.submit(os.path.join(repo, PACKED_EXAMPLE),
                          params={"corpus": corpus},
                          presets=[os.path.join(repo, GPU_PRESET), preset],
                          project="chip-smoke")
    clock = _ReconcileClock(agent)
    passes = _PassClock(agent)
    exited: dict = {}
    stop = threading.Event()
    watcher = threading.Thread(target=_watch_exit,
                               args=(agent, record.uuid, exited, stop),
                               daemon=True)
    watcher.start()
    try:
        status = agent.run_until_done(record.uuid, timeout=900)
    finally:
        stop.set()
        watcher.join()
    t_done = time.time()
    reconciles = clock.close()
    dirty_done = meminfo().get("Dirty", 0)
    record = plane.get_run(record.uuid)
    art = plane.run_artifacts_dir(record.uuid)
    log = os.path.join(art, "logs", "main-0.log")
    conditions = plane.get_statuses(record.uuid)
    history = [c["type"] for c in conditions]
    if status != V1Statuses.SUCCEEDED:
        fail(f"{label}: the run ended {status.value}: "
             f"{conditions[-1].get('message')}\n{_tail(log)}")
    telemetry_plane(plane, record.uuid, passes)

    # 3. What compilation produced.
    plan = record.launch_plan
    procs = plan["processes"]
    if plan["numProcesses"] != 1 or len(procs) != 1:
        fail(f"{label}: {plan['numProcesses']} processes, want 1")
    if list(procs[0]["command"]) + list(procs[0]["args"]) != LAUNCHER:
        fail(f"{label}: the process runs {procs[0]['command']}, not the "
             f"port's launcher {LAUNCHER}")
    job = json.loads(procs[0]["env"][ENV_JAXJOB_SPEC])
    init_kinds = [p["kind"] for p in plan["init"]]
    print(f"{label}: {PACKED_EXAMPLE} + {GPU_PRESET} + H100_PRESET "
          f"submitted and compiled by the port's plane: kind "
          f"{plan['runKind']}, {plan['numProcesses']} process, command "
          f"{procs[0]['command'][1:]}, resources {plan['resources']}, init "
          f"{init_kinds}, sidecars "
          f"{[c['kind'] for c in plan['sidecars']]}; runtime "
          f"{job['runtime']}; mesh {job.get('mesh')}; checkpointing "
          f"{job['checkpointing']}", flush=True)

    # 4. The record and the tracking record, through the plane.
    if history != SUBPROCESS_HISTORY or not all(
            can_transition(V1Statuses(a), V1Statuses(b))
            for a, b in zip(history, history[1:])):
        fail(f"{label}: status history {history}, want "
             f"{SUBPROCESS_HISTORY}, each hop legal")
    statuses = [r["status"] for r in events.read_jsonl(
        os.path.join(art, "statuses.jsonl"))]
    losses = {r["step"]: r["value"] for r in
              plane.streams.get_metrics(record.uuid, ["loss"])["loss"]}
    tracked = plane.streams.get_outputs(record.uuid)
    artifacts = plane.streams.list_artifacts(record.uuid)
    if (statuses != ["running", "succeeded"]
            or sorted(losses) != list(range(1, TRAIN_STEPS))
            or not all(math.isfinite(v) for v in losses.values())
            or tracked.get("steps") != TRAIN_STEPS
            or not any("checkpoints" in a for a in artifacts)):
        fail(f"{label}: tracking record: statuses {statuses}, loss events "
             f"{losses}, outputs steps {tracked.get('steps')}, checkpoint "
             f"artifacts {[a for a in artifacts if 'checkpoints' in a][:3]}")
    if "auth" not in init_kinds or not os.path.exists(
            os.path.join(art, ".auth")):
        fail(f"{label}: the auth init phase wrote no {art}/.auth "
             f"(init {init_kinds})")

    # 5. The trace: the gang's `execute` span, the launcher's spans under
    # it (the executor passes POLYAXON_TRACE_PARENT).
    spans = [r for r in read_trace(art) if r.get("type") == "span"]
    names = {}
    for span in spans:
        names.setdefault(span["name"], []).append(span)
    execute = (names.get("execute") or [None])[0]
    runtime = (names.get("runtime") or [None])[0]
    if (execute is None or runtime is None
            or runtime["parent_id"] != execute["span_id"]
            or not all(s["parent_id"] == runtime["span_id"]
                       for n in ("jit_compile", "step", "checkpoint")
                       for s in names.get(n, [None]) if s)
            or not all(names.get(n) for n in ("jit_compile", "step",
                                              "checkpoint"))):
        fail(f"{label}: trace: spans "
             f"{[(s['name'], s['span_id'], s['parent_id']) for s in spans]}")
    compile_ms = names["compile"][0]["duration_ms"]

    # 6. The checkpoint and the launches.
    ckdir = os.path.join(art, "checkpoints")
    if TRAIN_STEPS not in _store_steps(ckdir):
        fail(f"{label}: no committed step {TRAIN_STEPS} in {ckdir}: "
             f"{_store_steps(ckdir)}")
    lines = _json_lines(log)
    outputs = next((r["outputs"] for r in lines if "outputs" in r), None)
    launches = next((r["launches"] for r in lines if "launches" in r), None)
    if outputs is None or launches is None:
        fail(f"{label}: no result from the launcher:\n{_tail(log)}")
    want_bwd = layers * TRAIN_ACCUM * TRAIN_STEPS
    if launches != {"flash_fwd": 2 * want_bwd, "flash_bwd_dkdv": want_bwd,
                    "flash_bwd_dq": want_bwd, "paged_decode": 0}:
        fail(f"{label}: the launcher launched {launches}; each backward "
             f"kernel must run {want_bwd} times (layers x microbatches x "
             f"steps), the forward twice as often")
    t0 = time.perf_counter()
    mgr, state, step, want, tier = restore_checked(torch, llama, job, ckdir,
                                                   label)
    t_check = time.perf_counter() - t0
    restore_s = mgr.restore_seconds
    mgr.close()
    del state
    torch.cuda.empty_cache()
    print(f"{label}: {status.value}, history {history}, launcher statuses "
          f"{statuses}, loss events "
          f"{ {s: round(v, 5) for s, v in sorted(losses.items())} }, "
          f"outputs steps={tracked['steps']}, .auth written, spans "
          f"{sorted(names)} (runtime under execute); step {step} restored "
          f"here from tier {tier} (restore_s {restore_s}; with the state's "
          f"init and the CRC check {t_check:.1f}s), {len(want)} leaf "
          f"CRC-32s equal the manifest's; launches {launches}", flush=True)
    # The launcher's own log lines, timestamped: where its start-up goes.
    for line in open(log, errors="replace"):
        if " INFO " in line or " WARNING " in line:
            print(f"  {label} log: {line.rstrip()}", flush=True)

    # 7. The plane's timings, from the record's conditions (wall clock),
    # the compile span, and the process's exit as the watcher saw it.
    at = {c["type"]: _iso_s(c["created_at"]) for c in conditions}
    proc_wall = exited["exit"] - at["running"] if "exit" in exited \
        else float("nan")
    # The launcher's first log line (its local time), against the start.
    first_log = next((line[:23] for line in open(log, errors="replace")
                      if " INFO " in line), None)
    startup = (time.mktime(time.strptime(first_log[:19],
                                         "%Y-%m-%d %H:%M:%S"))
               + int(first_log[20:23]) / 1e3 - at["running"]
               if first_log else float("nan"))
    submit_to_done = at["succeeded"] - t_submit
    print(f"{label}: plane: submit_to_compiled_ms="
          f"{1e3 * (at['compiled'] - t_submit):.1f} compile_ms="
          f"{compile_ms:.1f} queued_to_process_start_s="
          f"{at['running'] - at['queued']:.3f} process_wall_s="
          f"{proc_wall:.2f} (start to the loop's first log line "
          f"{startup:.2f}) process_exit_to_succeeded_s="
          f"{at['succeeded'] - exited.get('exit', float('nan')):.3f} "
          f"submit_to_succeeded_s={submit_to_done:.2f} "
          f"plane_overhead_s={submit_to_done - proc_wall:.2f} (agent poll "
          f"0.2 s); run_until_done returned "
          f"{t_done - at['succeeded']:.3f}s after the succeeded condition "
          f"(submit to return {t_done - t_submit:.2f}s); host dirty page "
          f"cache {exited.get('dirty', 0) / 1e9:.2f} GB at the process's "
          f"exit, {dirty_done / 1e9:.2f} GB at the return; {reconciles}",
          flush=True)

    # 8. The numbers, beside phase 4's on synthetic packed data. MFU over
    # the timed steps, for both: tokens/s x training FLOPs per token over
    # the card's bf16 peak.
    seq = job["runtime"]["seq_len"]
    peak = peak_flops(torch.cuda.get_device_name(0))

    def mfu(result_throughput, n_params):
        return (result_throughput * train_flops_per_token(
            "llama3_1b", seq, n_params) / peak) if peak else float("nan")

    cp = outputs["checkpoint"]
    prep = [line.rsplit(" in ", 1)[-1].strip() for line in
            open(log, errors="replace") if "snapshot buffer ready" in line]
    print(f"{label}: llama3_1b {layers} layers on {ndocs} text documents: "
          f"tokens_per_s={outputs['throughput']:.1f} mfu="
          f"{mfu(outputs['throughput'], outputs['param_count']):.4f} over "
          f"the timed steps (phase 4, synthetic packed rows: "
          f"tokens_per_s={train_result.throughput:.1f} mfu="
          f"{mfu(train_result.throughput, train_result.param_count):.4f}); "
          f"first_step_s={outputs['compile_time_s']:.1f}; checkpoint "
          f"bytes={cp['bytes']} (predicted {ckpt_bytes}); page locking "
          f"{prep}; save wait_s={cp['save_wait_s']} snapshot_s="
          f"{cp['snapshot_s']} commit_s={cp['commit_s']}; final_loss="
          f"{outputs['final_metrics']['loss']:.5f}; phase_s="
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    if cp["publish_errors"]:
        fail(f"{label}: a checkpoint commit failed")
    return launches


# ------------------------------------------- the acceptance sweep on the card
# A copy of tests/test_acceptance.py's HYPERBAND_SWEEP: Hyperband over the
# learning rate (maxIterations 4, eta 2, seed 7; `steps` is the resource),
# every trial llama_200m at full width and depth (12 layers, dim 1024,
# head_dim 64: the flash kernels) on one device, with checkpoints as the
# composed-loop test has them. The trials save once, at their end
# (intervalSteps = maxIterations, one kept): 14 trials of 2.49 GB must fit
# in DRILL_DISK_BUDGET, where a save every step would leave up to two
# checkpoints per trial (the store's and the spill's older link).
SWEEP_MODEL = "llama_200m"
SWEEP_MAX_STEPS = 4
SWEEP = {
    "kind": "operation",
    "name": "lr-sweep-h100",
    "matrix": {
        "kind": "hyperband", "maxIterations": SWEEP_MAX_STEPS, "eta": 2,
        "resource": {"name": "steps", "type": "int"},
        "metric": {"name": "loss", "optimization": "minimize"},
        "resume": False, "seed": 7,
        "params": {"lr": {"kind": "loguniform",
                          "value": {"low": -9.2, "high": -2.3}}},
    },
    "component": {
        "inputs": [
            {"name": "lr", "type": "float"},
            {"name": "steps", "type": "int", "value": 2, "isOptional": True},
        ],
        "run": {
            "kind": "jaxjob",
            "mesh": {"axes": {"dp": 1}},
            "checkpointing": {"enabled": True,
                              "intervalSteps": SWEEP_MAX_STEPS,
                              "maxToKeep": 1, "asyncSave": False},
            "runtime": {
                "model": SWEEP_MODEL, "dataset": "lm_synthetic",
                "steps": "{{ params.steps }}", "seq_len": 2048,
                "global_batch_size": 8, "learning_rate": "{{ params.lr }}",
                "attention_impl": "flash", "log_every": 1,
            },
        },
    },
}
SWEEP_NEW_TOKENS = 5


def sweep(torch, flash, paged):
    """Phase 10: the acceptance sweep on the card, in a fresh temporary
    directory. Returns the launch counts of the sweep and of serving its
    best trial."""
    import shutil
    import tempfile

    from polyaxon_tpu_torch.runtime import tiers

    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-sweep-")
    try:
        return _sweep(torch, flash, paged, tmp)
    finally:
        tiers.TIER0.clear()
        shutil.rmtree(tmp, ignore_errors=True)


def _sweep(torch, flash, paged, tmp):
    import shutil

    from polyaxon_tpu_torch.agent import Agent
    from polyaxon_tpu_torch.controlplane import ControlPlane
    from polyaxon_tpu_torch.lifecycle import V1Statuses
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.polyflow.matrix import V1Hyperband
    from polyaxon_tpu_torch.serving.server import ServingServer
    from polyaxon_tpu_torch.tracking.systemmetrics import meminfo
    from polyaxon_tpu_torch.tune import HyperbandManager

    label = "sweep"
    t_phase = time.perf_counter()
    # The most trials the sweep can spawn, each leaving one checkpoint on
    # the disk and, in-process, one tier-0 replica in host memory.
    hb = HyperbandManager(V1Hyperband.from_dict(SWEEP["matrix"]))
    most = sum(hb.rung_shape(s, i)[0] for s in hb.brackets()
               for i in range(hb.rungs_in_bracket(s)))
    free_disk = shutil.disk_usage(tmp).free
    free_host = meminfo()["MemAvailable"]
    layers, ckpt_bytes = fit_depth(torch, llama, free_disk, free_host, most,
                                   label, model=SWEEP_MODEL, host_states=most)
    spec = json.loads(json.dumps(SWEEP))
    model = SWEEP_MODEL
    if layers < llama.CONFIGS[SWEEP_MODEL].n_layers:
        spec["component"]["run"]["runtime"]["n_layers"] = layers
        model = f"{SWEEP_MODEL}_{layers}l"
        llama.CONFIGS[model] = dataclasses.replace(
            llama.CONFIGS[SWEEP_MODEL], n_layers=layers)
    print(f"{label}: {SWEEP_MODEL} {layers} layers, at most {most} trials "
          f"of {ckpt_bytes / 1e9:.3f} GB per checkpoint ("
          f"{most * ckpt_bytes / 1e9:.2f} GB of disk, budget "
          f"{DRILL_DISK_BUDGET / 1e9:.1f} GB, {free_disk / 1e9:.1f} GB free; "
          f"as many tier-0 replicas in {free_host / 1e9:.1f} GB of host "
          f"memory)", flush=True)

    plane = ControlPlane(os.path.join(tmp, "home"))
    agent = Agent(plane, max_concurrent=2, in_process=True)
    _zero(flash, paged)
    t0 = time.perf_counter()
    record = plane.submit(spec, project="chip-smoke")
    status = agent.run_until_done(record.uuid, timeout=900)
    wall = time.perf_counter() - t0
    counts = _counts(flash, paged)
    trials = plane.list_runs(pipeline_uuid=record.uuid)
    if status != V1Statuses.SUCCEEDED:
        fail(f"{label}: the sweep ended {status.value}; trials "
             f"{[(t.name, t.status.value, (plane.get_statuses(t.uuid) or [{}])[-1].get('message')) for t in trials]}")

    # The asserts of tests/test_acceptance.py:115-132.
    rungs = {(t.meta or {}).get("rung", 0) for t in trials}
    steps_by_rung: dict = {}
    for t in trials:
        steps_by_rung.setdefault((t.meta or {}).get("rung", 0), set()).add(
            t.meta["trial_params"]["steps"])
    if not (len(trials) >= 3
            and any(t.status == V1Statuses.SUCCEEDED for t in trials)
            and max(rungs) >= 1
            and min(steps_by_rung[max(rungs)]) > min(steps_by_rung[0])):
        fail(f"{label}: {len(trials)} trials, rungs {sorted(rungs)}, steps "
             f"by rung {steps_by_rung}")

    # Each trial: its steps, a finite loss at every emission and at the
    # end, its wall time in the plane (running to succeeded).
    total_steps = 0
    for t in trials:
        params = t.meta["trial_params"]
        out = plane.streams.get_outputs(t.uuid)
        losses = [r["value"] for r in plane.streams.get_metrics(
            t.uuid, ["loss"])["loss"]]
        final = out.get("final_loss")
        first = [r["value"] for r in plane.streams.get_metrics(
            t.uuid, ["compile_time_s"])["compile_time_s"]]
        at = {c["type"]: _iso_s(c["created_at"])
              for c in plane.get_statuses(t.uuid)}
        if (t.status != V1Statuses.SUCCEEDED
                or out.get("steps") != params["steps"]
                or len(losses) != params["steps"] - 1
                or not all(math.isfinite(v) for v in losses + [final])):
            fail(f"{label}: trial {t.name} ({t.status.value}): outputs "
                 f"{out}, loss events {losses}")
        total_steps += params["steps"]
        print(f"{label}: trial {t.name} bracket {t.meta['bracket']} rung "
              f"{t.meta['rung']} lr={params['lr']:.6g} steps="
              f"{params['steps']} wall_s="
              f"{at['succeeded'] - at['running']:.2f} first_step_s="
              f"{first[0] if first else float('nan'):.2f} final_loss="
              f"{final:.5f} tokens_per_s={out.get('throughput', 0.0):.1f}",
              flush=True)
    want_bwd = layers * total_steps  # one microbatch per step
    if counts != {"flash_fwd": want_bwd, "flash_bwd_dkdv": want_bwd,
                  "flash_bwd_dq": want_bwd, "paged_decode": 0}:
        fail(f"{label}: the trials launched {counts}; each flash kernel "
             f"must run {want_bwd} times ({layers} layers x "
             f"{total_steps} steps summed over the trials, remat none)")
    print(f"{label}: {status.value}: {len(trials)} trials, "
          f"{total_steps} trial steps, wall_s={wall:.1f}, launches "
          f"{counts}", flush=True)
    t0 = time.perf_counter()
    fleet_verdicts = plane.verify()
    unresolved = [(a["rule"], a.get("value"), a.get("threshold"))
                  for v in fleet_verdicts["verdicts"]
                  for a in v["evidence"].get("unresolved_alerts", [])]
    print(f"16b. sweep plane verify() in "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms: passed="
          f"{fleet_verdicts['passed']} counts={fleet_verdicts['counts']}; "
          f"{ {v['invariant']: v['verdict'] for v in fleet_verdicts['verdicts']} }"
          f"; unresolved alerts (rule, value, threshold) {unresolved}",
          flush=True)

    # The best trial's checkpoint, served.
    scored = [(plane.get_metric(t.uuid, "loss"), t) for t in trials]
    best = min(((v, t) for v, t in scored if v is not None),
               key=lambda vt: vt[0])[1]
    ckpt = os.path.join(plane.run_artifacts_dir(best.uuid), "checkpoints")
    _zero(flash, paged)
    t0 = time.perf_counter()
    with ServingServer(model, ckpt, batching="continuous",
                       kv="paged") as server:
        t_load = time.perf_counter() - t0
        req = urllib.request.Request(
            server.url + "/v1/generate", method="POST",
            data=json.dumps({"tokens": [[5, 6, 7]],
                             "max_new_tokens": SWEEP_NEW_TOKENS}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            served = json.load(resp)
    serve_counts = _counts(flash, paged)
    tokens = served["tokens"][0]
    if len(tokens) != SWEEP_NEW_TOKENS or not all(
            0 <= x < llama.CONFIGS[model].vocab_size for x in tokens) or \
            not all(serve_counts[k] > 0 for k in SERVING_KERNELS):
        fail(f"{label}: serving the best trial's checkpoint returned "
             f"{served} with launches {serve_counts}")
    print(f"{label}: best trial {best.name} (loss "
          f"{plane.get_metric(best.uuid, 'loss'):.5f}) served from {ckpt}: "
          f"loaded in {t_load:.1f}s, tokens {tokens}, launches "
          f"{serve_counts}; phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    del server
    torch.cuda.empty_cache()
    return counts, serve_counts


# ------------------------------------------ the other families (11-15)
MOE_EXAMPLE = "examples/moe_expert_parallel.yaml"
T5_EXAMPLE = "examples/t5_seq2seq.yaml"
VIT_EXAMPLE = "examples/hyperband_vit.yaml"
MNIST_EXAMPLE = "examples/mnist.yaml"
LORA_EXAMPLE = "examples/lora_finetune.yaml"
# Phase 11: moe_8x200m's global batch of 32 x 2048 in 8 microbatches of 4
# rows; 6 steps.
MOE_STEPS = 6
MOE_ACCUM = 8
# Phase 12: new tokens per request; the served mixtral_8x7b's depth (16
# of its 32 layers: 47 GB of bf16 weights) and its eight prompts.
MOE_NEW_TOKENS = 32
MIXTRAL_LAYERS = 16
MIXTRAL_PROMPTS = (2048, 1500, 1024, 700, 300, 129, 37, 5)
# Phase 13: t5_base's global batch of 64 x 512 in 2 microbatches; 6
# steps; served prompts of mixed encoder lengths.
T5_STEPS = 6
T5_ACCUM = 2
T5_NEW_TOKENS = 32
T5_PROMPTS = (512, 400, 300, 200, 129, 64, 37, 5)
# Phase 15: lora_finetune.yaml's runtime at 3 steps of global batch 4 in
# microbatches of 1 (its 16-row batch at one row per microbatch would be
# 16 microbatches a step), llama3_8b cut to LORA_LAYERS of its 32 layers
# at full width: its 32 GB checkpoint took 115-130 s of the script's time
# budget, which phase 20 needs.
LORA_STEPS = 3
LORA_BATCH = 4
LORA_LAYERS = 4


def compile_example(path: str, label: str, *, params=None, axes=None,
                    runtime=None) -> dict:
    """``path`` compiled by the port (the gpu preset, then a preset of one
    process, the mesh ``axes`` at one device each, and the ``runtime``
    patch); returns the job its one process runs (the plan's
    POLYAXON_JAXJOB_SPEC)."""
    from polyaxon_tpu_torch.compiler import ENV_JAXJOB_SPEC, compile_operation
    from polyaxon_tpu_torch.polyaxonfile import (check_polyaxonfile,
                                                 resolve_operation_context)

    repo = os.path.dirname(os.path.abspath(__file__))
    patch: dict = {"numProcesses": 1}
    if axes:
        patch["mesh"] = {"axes": {a: 1 for a in axes}}
    if runtime:
        patch["runtime"] = runtime
    preset = {"isPreset": True, "patchStrategy": "post_merge",
              "runPatch": patch}
    op = check_polyaxonfile([os.path.join(repo, path)], params=params,
                            presets=[os.path.join(repo, GPU_PRESET), preset])
    plan = compile_operation(resolve_operation_context(op),
                             run_uuid="chip-smoke", artifacts_root="/tmp")
    if plan.num_processes != 1:
        fail(f"{label}: the plan has {plan.num_processes} processes")
    job = json.loads(plan.processes[0].env[ENV_JAXJOB_SPEC])
    cut = f"; cut: one device for its mesh {sorted(axes)} (this machine " \
          "has one H100)" if axes else ""
    print(f"{label}: {path} compiled by the port: runtime "
          f"{job['runtime']}, mesh {job.get('mesh')}{cut}", flush=True)
    return job


def launch_in_process(job: dict, artifacts_dir: str, label: str):
    """The port's launcher (``runtime/launch.py main``) on ``job`` in this
    process, its stdout captured; returns (emissions, outputs, launches,
    wall seconds). Fails unless it exits 0."""
    import contextlib
    import io

    from polyaxon_tpu_torch.runtime import launch

    env = {launch.ENV_JAXJOB_SPEC: json.dumps(job),
           launch.ENV_ARTIFACTS_PATH: artifacts_dir,
           launch.ENV_RUN_UUID: "chip-smoke"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = launch.main(device="cuda")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    lines = [json.loads(line) for line in out.getvalue().splitlines()
             if line.startswith("{")]
    if rc != 0:
        fail(f"{label}: the launcher exited {rc}:\n"
             f"{out.getvalue()[-3000:]}")
    emitted = [d for d in lines if "step" in d]
    outputs = next(d["outputs"] for d in lines if "outputs" in d)
    launches = next(d["launches"] for d in lines if "launches" in d)
    return emitted, outputs, launches, wall


class _CausalSplit:
    """Counts the flash kernels' calls by their causal flag, around the
    wrappers the autograd function calls (``flash_fwd_cuda``,
    ``flash_bwd_cuda``)."""

    def __init__(self, flash):
        self.flash = flash
        self.counts = {"fwd causal": 0, "fwd non-causal": 0,
                       "bwd causal": 0, "bwd non-causal": 0}

    def _wrap(self, kind, fn):
        def counted(*args, **kw):
            name = f"{kind} {'causal' if kw['causal'] else 'non-causal'}"
            self.counts[name] += 1
            return fn(*args, **kw)
        return counted

    def __enter__(self):
        self.real = (self.flash.flash_fwd_cuda, self.flash.flash_bwd_cuda)
        self.flash.flash_fwd_cuda = self._wrap("fwd", self.real[0])
        self.flash.flash_bwd_cuda = self._wrap("bwd", self.real[1])
        return self

    def __exit__(self, *exc):
        self.flash.flash_fwd_cuda, self.flash.flash_bwd_cuda = self.real


def _check_emissions(label, emitted, steps, keys=("loss", "grad_norm")):
    if len(emitted) != steps - 1:
        fail(f"{label}: {len(emitted)} emissions for {steps} steps")
    for vals in emitted:
        for key in keys:
            if not math.isfinite(vals.get(key, float("nan"))):
                fail(f"{label}: step {vals['step']} {key} is "
                     f"{vals.get(key)}")


def moe_training(torch, flash, paged):
    """Phase 11: examples/moe_expert_parallel.yaml compiled with the gpu
    preset and run by the port's launcher: moe_8x200m at full width and
    depth, lm_synthetic, seq 2048, global batch 32 in MOE_ACCUM
    microbatches, ragged dispatch, MOE_STEPS steps. Each backward kernel
    once per layer and microbatch; router_aux reported; tokens/s and MFU
    from the active parameters. Returns the launches."""
    import shutil
    import tempfile

    from polyaxon_tpu_torch.models import moe

    label = "11. moe training"
    t_phase = time.perf_counter()
    cfg = moe.CONFIGS["moe_8x200m"]
    job = compile_example(MOE_EXAMPLE, label, axes=("dp", "ep"),
                          runtime={"steps": MOE_STEPS,
                                   "grad_accum_steps": MOE_ACCUM,
                                   "log_every": 1})
    tmp = tempfile.mkdtemp(prefix="chip-smoke-moe-")
    try:
        _zero(flash, paged)
        torch.cuda.reset_peak_memory_stats()
        emitted, outputs, launches, wall = launch_in_process(job, tmp, label)
        counts = _counts(flash, paged)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _check_emissions(label, emitted, MOE_STEPS,
                     keys=("loss", "grad_norm", "router_aux", "ce_loss"))
    want = cfg.n_layers * MOE_ACCUM * MOE_STEPS
    if counts != launches or counts != {
            "flash_fwd": want, "flash_bwd_dkdv": want, "flash_bwd_dq": want,
            "paged_decode": 0}:
        fail(f"{label}: launches {counts} (launcher's line {launches}); "
             f"each flash kernel must run {want} times (layers x "
             f"microbatches x steps)")
    for vals in emitted:
        print(f"{label} step {vals['step']}: loss={vals['loss']:.5f} "
              f"ce={vals['ce_loss']:.5f} router_aux="
              f"{vals['router_aux']:.5f} grad_norm={vals['grad_norm']:.4f} "
              f"step_ms={vals['step_time_ms']:.1f} tokens_per_s="
              f"{vals['tokens_per_sec']:.1f} mfu={vals.get('mfu')}",
              flush=True)
    last = emitted[-1]
    print(f"{label}: params={outputs['param_count'] / 1e9:.3f}B "
          f"tokens_per_s={outputs['throughput']:.1f} "
          f"mfu(active params)={last.get('mfu')} "
          f"first_step_s={outputs['compile_time_s']:.1f} wall_s={wall:.1f} "
          f"max_memory_allocated_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches={counts} "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return counts


class _Routing:
    """Records or replays the MoE router's choices through ``moe._top_k``
    (the one place either dispatch decides a routing). Every call's
    expert ids [T, K] are appended to ``calls``, in the order the model
    makes them. With ``replay`` (one [T, K] per call, in that order; -1 =
    not recorded), each call takes the recorded ids instead of its own
    top-k, the router's probabilities at those ids renormalized as the
    router does; ``flips`` counts the tokens of each call whose own
    choice would have differed. A rounding that flips a near-tie routing
    choice changes the function by more than a rounding: replayed, two
    computations of one function differ by their roundings alone."""

    def __init__(self, torch, moe, replay=None):
        self.torch, self.moe, self.replay = torch, moe, replay
        self.calls, self.flips = [], []

    def __enter__(self):
        torch, real = self.torch, self.moe._top_k
        self.real = real

        def top_k(probs, k):
            top_probs, idx = real(probs, k)
            if self.replay is not None:
                want = self.replay[len(self.calls)].to(idx.device)
                if want.shape != idx.shape:
                    fail(f"routing replay: call {len(self.calls)} routes "
                         f"{tuple(idx.shape)}, recorded {tuple(want.shape)}")
                known = want >= 0
                self.flips.append(int(((idx.sort(-1).values
                                        != want.sort(-1).values).any(-1)
                                       & known.all(-1)).sum()))
                idx = torch.where(known, want, idx)
                top_probs = probs.gather(-1, idx)
                top_probs = top_probs / top_probs.sum(-1, keepdim=True)
            self.calls.append(idx)
            return top_probs, idx

        self.moe._top_k = top_k
        return self

    def __exit__(self, *exc):
        self.moe._top_k = self.real


def moe_parity(torch, flash):
    """Phase 11, first-step parity: one 1x2048 microbatch of moe_8x200m
    from the same f32 weights, the routing of each compared run replayed
    from the kernel path's (``_Routing``; the tokens whose own choice
    would differ are printed). Held within phase 5's tolerances: the loss
    and layer 0's router, w_gate and wq gradients of the kernel path
    against the plain path (einsum attention) at no-drop capacity
    (n_experts / experts_per_token) and at the training capacity, and of
    ragged against dense dispatch at no-drop capacity; and phase 5's
    backward witnesses (each backward call against the plain backward
    with the kernels' bf16 roundings, and the kernel path against the
    forward kernel with the f32 plain backward)."""
    from polyaxon_tpu_torch.models import moe
    from polyaxon_tpu_torch.runtime.data import lm_synthetic

    base = moe.CONFIGS["moe_8x200m"]
    params = moe.init(base, torch.Generator(device="cuda").manual_seed(SEED),
                      device="cuda")["params"]
    for t in _leaves(params):
        t.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(next(lm_synthetic(
        1, seq_len=2048, vocab_size=base.vocab_size,
        seed=SEED + 3))["tokens"]).cuda().long()}
    names = ("router", "w_gate", "wq")
    no_drop = base.n_experts / base.experts_per_token

    def run(replay=None, **overrides):
        """(loss, layer-0 grads, routing calls, flips per call)."""
        cfg = dataclasses.replace(base, **overrides)
        with _Routing(torch, moe, replay) as routing:
            loss, _, _ = moe.apply(cfg, {"params": params, "state": {}},
                                   batch)
        loss.backward()
        grads = {n: params["layers"][n].grad[0].float().clone()
                 for n in names}
        for t in _leaves(params):
            t.grad = None
        torch.cuda.synchronize()
        return loss.item(), grads, routing.calls, routing.flips

    def compare(label, a, b):
        (la, ga, _, _), (lb, gb, _, flips) = a, b
        loss_rel = abs(la - lb) / abs(lb)
        rels = {n: ((ga[n] - gb[n]).norm() / gb[n].norm()).item()
                for n in names}
        print(f"11. moe first-step parity, {label}: loss {la:.6f} vs "
              f"{lb:.6f} rel={loss_rel:.3e}; layer-0 grad rel "
              + " ".join(f"{n}={r:.3e}" for n, r in rels.items())
              + f"; routing replayed, the compared run's own choice "
              f"differs for {sum(flips)} of {len(flips) * 2048} "
              f"(layer, token) pairs", flush=True)
        if not all(torch.isfinite(g).all() for g in ga.values()):
            fail(f"moe parity ({label}): non-finite gradients")
        return loss_rel, rels

    kernel = run(attention_impl="flash", capacity_factor=no_drop)
    kernel_tc = run(attention_impl="flash")
    held = [
        compare(f"kernel vs plain path at no-drop capacity {no_drop}",
                kernel, run(kernel[2], attention_impl="xla",
                            capacity_factor=no_drop)),
        compare(f"ragged vs dense dispatch at no-drop capacity {no_drop}",
                kernel, run(kernel[2], attention_impl="flash",
                            capacity_factor=no_drop, dispatch="dense")),
        compare(f"kernel vs plain path at the training capacity "
                f"{base.capacity_factor}", kernel_tc,
                run(kernel_tc[2], attention_impl="xla"))]

    # Phase 5's witnesses of the backward kernels.
    layer_errs = []
    kernel_bwd = flash.flash_bwd_cuda

    def held_bwd(*args, **kw):
        got = kernel_bwd(*args, **kw)
        want = flash_bwd_plain_bf16(*args, **kw)
        layer_errs.append(max(((g.float() - w.float()).abs().max()
                               / w.float().abs().max()).item()
                              for g, w in zip(got, want)))
        return got

    def swapped(fn):
        # The name _FlashFn.backward calls (MoEConfig has no
        # flash_bwd_impl field, as the reference's has none).
        flash.flash_bwd_cuda = fn
        try:
            return run(kernel[2], attention_impl="flash",
                       capacity_factor=no_drop)
        finally:
            flash.flash_bwd_cuda = kernel_bwd

    swapped(held_bwd)
    _, bwd_rel = compare(
        "kernel path vs the forward kernel with the f32 plain backward",
        kernel, swapped(flash.flash_bwd_plain))
    print(f"11. moe parity witness: {len(layer_errs)} backward calls held "
          f"against the plain backward with P and dS in bf16, worst "
          f"max|err| / max|plain| {max(layer_errs, default=0.0):.3e}",
          flush=True)
    if len(layer_errs) != base.n_layers \
            or max(layer_errs, default=0.0) > TRAIN_LAYER_BWD_TOL \
            or max(bwd_rel.values()) > TRAIN_BWD_REL_TOL:
        fail(f"moe parity: backward witnesses {layer_errs} (tol "
             f"{TRAIN_LAYER_BWD_TOL}), {bwd_rel} (tol {TRAIN_BWD_REL_TOL})")
    for (loss_rel, rels), label in zip(held, (
            "kernel vs plain", "ragged vs dense",
            "kernel vs plain at the training capacity")):
        if loss_rel > TRAIN_LOSS_REL_TOL or max(rels.values()) \
                > TRAIN_GRAD_REL_TOL:
            fail(f"moe parity ({label}): loss rel {loss_rel} (tol "
                 f"{TRAIN_LOSS_REL_TOL}), grad rel {rels} (tol "
                 f"{TRAIN_GRAD_REL_TOL})")
    del params
    torch.cuda.empty_cache()


def router_margin(torch, moe, cfg, params, tokens, j):
    """The routing of the token at position ``j`` of a prompt pass over
    ``tokens``: the smallest gap between some layer's K-th and (K+1)-th
    router logits, as a multiple of NEAR_TIE_ULPS bf16 spacings (printed
    where two engines' rows part)."""
    ratios, real = [], moe.moe_block
    K = cfg.experts_per_token

    def spy(c, h, router_w, *args, **kw):
        row = h.reshape(-1, h.shape[-1])[j]
        logits = (row @ router_w.to(c.dtype)).float()[None]
        top = logits.sort(descending=True).values[0]
        ratios.append(((top[K - 1] - top[K]) / _tie_tol(torch, logits)[0])
                      .item())
        return real(c, h, router_w, *args, **kw)

    moe.moe_block = spy
    try:
        with torch.no_grad():
            moe.hidden_states(cfg, params, torch.tensor(
                [tokens[:j + 1]], device="cuda"))
    finally:
        moe.moe_block = real
    return min(ratios)


class _EngineRoutes:
    """The routing one engine's MoE computed for each request, position
    by position, recorded through ``_Routing`` while it serves: its
    admission prefills (``_prefill_row``: the prompt from the radix hit
    on) and its decode steps (``_decode_logits``: each live slot's
    position). A position that a radix hit skipped is found by its
    context (the tokens up to it) among the other requests' prefills."""

    def __init__(self, torch, eng, routing, n_layers):
        self.torch, self.L = torch, n_layers
        self.own, self.by_context, self.prefills = {}, {}, []
        real_prefill, real_decode = eng._prefill_row, eng._decode_logits

        def routed_since(n0):  # [T, L, K]
            calls = routing.calls[n0:]
            if len(calls) != n_layers:
                fail(f"routing record: {len(calls)} router calls in one "
                     f"model call of {n_layers} layers")
            return torch.stack(calls, 1).cpu()

        def prefill_row(b, req, tokens, skip):
            n0 = len(routing.calls)
            real_prefill(b, req, tokens, skip)
            if skip < len(tokens):
                self.prefills.append((req, list(tokens), skip,
                                      routed_since(n0)))

        def decode_logits():
            live = [(b, req, int(eng._pos[b]))
                    for b, req in enumerate(eng._slot_req[:eng.slots])
                    if req is not None]
            n0 = len(routing.calls)
            logits = real_decode()
            routed = routed_since(n0)
            for b, req, pos in live:
                self.own[(id(req), pos)] = routed[b]
            return logits

        eng._prefill_row, eng._decode_logits = prefill_row, decode_logits

    def finish(self) -> None:
        for req, tokens, skip, routed in self.prefills:
            h = 0
            for t, tok in enumerate(tokens):
                h = hash((h, tok))
                if t >= skip:
                    self.own[(id(req), t)] = routed[t - skip]
                    self.by_context.setdefault((t, h), []).append(
                        routed[t - skip])

    def row(self, req, seq, n: int):
        """[n, L, K] expert ids of positions 0..n-1 of ``req``'s row
        ``seq`` (prompt and output); -1 where nothing was recorded or the
        prefills that computed a skipped position disagree."""
        torch = self.torch
        out = None
        h = 0
        for t in range(n):
            h = hash((h, seq[t]))
            r = self.own.get((id(req), t))
            if r is None:
                found = self.by_context.get((t, h), [])
                if found and all(torch.equal(f, found[0]) for f in found):
                    r = found[0]
            if out is None and r is not None:
                out = torch.full((n, *r.shape), -1, dtype=r.dtype)
            if r is not None:
                out[t] = r
        if out is None:
            fail("routing record: nothing recorded for a served row")
        return out


def _replayed_teacher(torch, moe, cfg, params, prompt, toks, routes):
    """``_teacher_logits`` over ``prompt + toks`` with the routing
    ``routes`` [positions, L, K] (-1: the pass's own choice) replayed."""
    n = len(prompt) + len(toks) - 1
    with _Routing(torch, moe, [routes[:n, i] for i in
                               range(routes.shape[1])]):
        return _teacher_logits(torch, moe, cfg, params, prompt, toks)


def moe_rows_check(torch, moe, cfg, params, label, prompts, rows, routes):
    """Greedy rows of two MoE engines over ``prompts`` (``rows`` and
    ``routes`` as {engine: (requests, outputs)} and {engine:
    _EngineRoutes}, the first engine the reference): each engine's every
    token must be the target's argmax given its own prefix, up to a
    near-tie, with the teacher replaying the routing that engine
    computed for the row; where two rows part, the engines' recorded
    routings must differ at some position of their common prefix, or
    the parting must sit at a near-tie of the reference teacher's
    logits. Returns (rows that part, of them those whose routings
    differ)."""
    (ref, (ref_reqs, ref_outs)), (other, (reqs, outs)) = rows.items()
    parted = excused = 0
    for i, p in enumerate(prompts):
        a, b = outs[i], ref_outs[i]
        seq_a, seq_b = p + a, p + b
        ra = routes[other].row(reqs[i], seq_a, len(seq_a) - 1)
        rb = routes[ref].row(ref_reqs[i], seq_b, len(seq_b) - 1)
        lb = _replayed_teacher(torch, moe, cfg, params, p, b, rb)
        _check_own_choice(torch, f"{label} row {i} {ref}", lb, b)
        la = _replayed_teacher(torch, moe, cfg, params, p, a, ra)
        _check_own_choice(torch, f"{label} row {i} {other}", la, a)
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        parted += 1
        n = len(p) + j
        known = ((ra[:n] >= 0) & (rb[:n] >= 0)).flatten(1).all(-1)
        differ = known & (ra[:n].sort(-1).values
                          != rb[:n].sort(-1).values).flatten(1).any(-1)
        margin = router_margin(torch, moe, cfg, params, seq_b, n - 1)
        top2 = torch.topk(lb[j], 2).values
        gap, tol = (top2[0] - top2[1]).item(), _tie_tol(torch,
                                                          lb[j][None])[0]
        where = differ.nonzero().flatten().tolist()
        print(f"  {label} row {i} parts at token {j}: routing differs "
              f"between the engines at {len(where)} of {n} positions "
              f"({int(known.sum())} recorded in both; first "
              f"{where[:3]}); logits top-2 gap {gap:.4f} (tol "
              f"{tol.item():.4f}); smallest router top-2 gap at the token "
              f"{margin:.3f} of the tolerance", flush=True)
        if where:
            excused += 1
        elif gap >= tol:
            fail(f"{label} row {i}: {other} parts from {ref} at token {j} "
                 f"({a[j]} vs {b[j]}) where both engines routed alike and "
                 f"the top-2 gap {gap:.4f} is not a near-tie (tol "
                 f"{tol.item():.4f})")
    return parted, excused


def moe_first_admission(torch, moe, cfg, params, prompt):
    """``compare_first_admission`` for an MoE: the first admission's
    prefill KV and first decode logits, kernel path against plain path,
    at no-drop capacity, the plain path replaying the kernel path's
    routing (``_Routing``), held over every position (max error over
    max value, MODEL_REL_TOL). Prints how many prompt positions the
    plain path would route otherwise in some layer."""
    nd = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    page = 16
    P = len(prompt) - 1
    n_pages = -(-(P + 1) // page) + 1
    tables = torch.full((1, n_pages), -1, dtype=torch.long, device="cuda")
    tables[0, :n_pages - 1] = torch.arange(1, n_pages, device="cuda")
    row = torch.tensor([prompt[:-1]], dtype=torch.long, device="cuda")
    tok = torch.tensor([prompt[-1]], dtype=torch.long, device="cuda")
    pos = torch.tensor([P], dtype=torch.long, device="cuda")
    plain = dataclasses.replace(nd, attention_impl="xla",
                                paged_attention_impl="gather")
    results, replay = {}, None
    for name, c in (("kernel", nd), ("plain", plain)):
        cache = moe.paged_init_cache(c, n_pages, page, device="cuda")
        with _Routing(torch, moe, replay) as routing:
            k, v = moe.paged_prefill_kv(c, params, row)
            moe.paged_insert_prefill(cache, k, v, tables[0], page)
            logits, _ = moe.decode_step_paged(c, params, cache, tok, pos,
                                              tables)
        torch.cuda.synchronize()
        results[name], replay = (k, v, logits), routing.calls
        del cache
    L = cfg.n_layers
    flips = routing.flips
    out = {}
    for i, what in enumerate(("k", "v", "logits")):
        a, b = results["kernel"][i].float(), results["plain"][i].float()
        if not torch.isfinite(a).all():
            fail(f"moe first admission: non-finite {what}")
        out[what] = ((a - b).abs().max() / b.abs().max()).item()
        if out[what] > MODEL_REL_TOL:
            fail(f"moe first admission {what}: kernel path vs plain path "
                 f"relative max err {out[what]} (tol {MODEL_REL_TOL}), "
                 f"the routing replayed")
    print(f"moe first admission (prompt {len(prompt)}, no-drop capacity, "
          f"the plain path replaying the kernel path's routing): rel err "
          f"k={out['k']:.3e} v={out['v']:.3e} logits={out['logits']:.3e}; "
          f"the plain path's own routing would differ for "
          f"{sum(flips[:L])} (layer, position) pairs of the prompt's "
          f"{L * P} and {sum(flips[L:])} of the decoded token's {L}",
          flush=True)


def moe_serving(torch, llama, flash, paged):
    """Phase 12: moe_8x200m (bf16, random weights from SEED) on the dense
    and the paged engines over phase 2's mix at no-drop capacity, each
    engine's routing recorded (``moe_rows_check`` holds the rows; radix
    hits must fire), the mix at the default capacity on the paged engine
    (token streams printed, not held: ROADMAP Queue 3), then mixtral_8x7b
    at full width and MIXTRAL_LAYERS of its layers on the paged engine,
    its first admission held against the plain path. Returns each run's
    launches."""
    import numpy as np

    from polyaxon_tpu_torch.models import moe
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine

    label = "12. moe serving"
    t_phase = time.perf_counter()
    base = moe.CONFIGS["moe_8x200m"]
    params = moe.init(base, torch.Generator(device="cuda").manual_seed(SEED),
                      device="cuda", param_dtype=base.dtype)["params"]
    no_drop = dataclasses.replace(
        base, capacity_factor=base.n_experts / base.experts_per_token)
    # Phase 2's mix, each prompt cut to leave room for the new tokens in
    # moe_8x200m's 2048 positions.
    prompts = [p[:base.max_seq_len - MOE_NEW_TOKENS]
               for p in make_prompts(base.vocab_size)]
    runs, rows, routes = [], {}, {}
    for name, cfg, kv in (("dense", no_drop, "dense"),
                          ("paged", no_drop, "paged"),
                          ("paged, capacity 1.25", base, "paged")):
        eng = ContinuousBatchingEngine("moe_8x200m", cfg, params, slots=8,
                                       kv=kv, page_size=16, device="cuda")
        # The no-drop engines record the routing they compute per row.
        routing = _Routing(torch, moe) if cfg is no_drop else None
        if routing is not None:
            routing.__enter__()
            routes[name] = _EngineRoutes(torch, eng, routing, base.n_layers)
        try:
            _zero(flash, paged)
            reqs, o, wall = _run_engine_mix(eng, prompts, MOE_NEW_TOKENS)
            counts = _counts(flash, paged)
            stats = eng.stats()
            bad = eng.check_invariants() if kv == "paged" else []
        finally:
            eng.stop()
            if routing is not None:
                routing.__exit__()
        _check_outs(f"{label} {name}", prompts, o, MOE_NEW_TOKENS,
                    base.vocab_size)
        if bad:
            fail(f"{label} {name}: page pool invariants broken: {bad[:5]}")
        want_kernels = ("flash_fwd", "paged_decode") if kv == "paged" \
            else ("flash_fwd",)
        if any(counts[k] <= 0 for k in want_kernels):
            fail(f"{label} {name}: launches {counts}")
        if kv == "paged" and stats["prefill_tokens_skipped"] <= 0:
            fail(f"{label} {name}: no radix hit fired")
        print(f"{label} {name}: {len(prompts)} requests x {MOE_NEW_TOKENS} "
              f"tokens wall_s={wall:.2f} tokens_per_s="
              f"{len(prompts) * MOE_NEW_TOKENS / wall:.1f} "
              f"decode_step_ms_median={stats['decode_step_ms_median']:.2f} "
              f"prefill_tokens_skipped="
              f"{stats.get('prefill_tokens_skipped', 0)} launches={counts}"
              + (" (routing recorded)" if routing is not None else ""),
              flush=True)
        runs.append(counts)
        rows[name] = (reqs, o)
        if name in routes:
            routes[name].finish()
    parted, differ = moe_rows_check(
        torch, moe, no_drop, params, label, prompts,
        {k: rows[k] for k in ("dense", "paged")}, routes)
    outs = {k: o for k, (_, o) in rows.items()}
    same = sum(a == b for a, b in zip(outs["paged, capacity 1.25"],
                                      outs["paged"]))
    print(f"{label}: paged rows equal to dense {len(prompts) - parted}/"
          f"{len(prompts)}; of the {parted} that part, {differ} where the "
          f"two engines' recorded routings differ and "
          f"{parted - differ} at a near-tie of the logits; at capacity 1.25 "
          f"(full prefill drops, suffix prefill and decode do not) "
          f"{same}/{len(prompts)} rows equal the no-drop paged rows; "
          f"first 8 tokens of rows 0-3 at 1.25: "
          f"{[o[:8] for o in outs['paged, capacity 1.25'][:4]]}",
          flush=True)
    del params
    torch.cuda.empty_cache()

    # mixtral_8x7b at full width, MIXTRAL_LAYERS of its layers.
    full = moe.CONFIGS["mixtral_8x7b"]
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = moe.init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                      device="cuda", param_dtype=cfg.dtype)["params"]
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{label}: mixtral_8x7b at full width (dim {cfg.dim}, "
          f"{cfg.n_heads}:{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
          f"{cfg.n_experts} experts of ffn {cfg.ffn_dim}); cut: "
          f"{MIXTRAL_LAYERS} of its {full.n_layers} layers "
          f"({n_params / 1e9:.2f}B params, {2 * n_params / 1e9:.1f} GB "
          f"bf16; the full depth's "
          f"{2 * n_params * full.n_layers / MIXTRAL_LAYERS / 1e9:.0f} GB do "
          f"not fit one card); init {time.perf_counter() - t0:.1f}s",
          flush=True)
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in MIXTRAL_PROMPTS]
    eng = ContinuousBatchingEngine("mixtral_8x7b", cfg, params, slots=8,
                                   kv="paged", page_size=16, max_len=4096,
                                   device="cuda")
    try:
        _zero(flash, paged)
        _, o, wall = _run_engine_mix(eng, prompts, MOE_NEW_TOKENS)
        counts = _counts(flash, paged)
        stats = eng.stats()
        bad = eng.check_invariants()
    finally:
        eng.stop()
    _check_outs(f"{label} mixtral", prompts, o, MOE_NEW_TOKENS,
                cfg.vocab_size)
    if bad or counts["flash_fwd"] <= 0 or counts["paged_decode"] <= 0:
        fail(f"{label} mixtral: launches {counts}, invariants {bad[:5]}")
    print(f"{label} mixtral_8x7b ({MIXTRAL_LAYERS} layers): "
          f"{len(prompts)} requests (prompts {list(MIXTRAL_PROMPTS)}) x "
          f"{MOE_NEW_TOKENS} tokens wall_s={wall:.2f} "
          f"decode_step_ms_median={stats['decode_step_ms_median']:.2f} "
          f"launches={counts}", flush=True)
    runs.append(counts)
    moe_first_admission(torch, moe, cfg, params, prompts[0])
    del params
    torch.cuda.empty_cache()
    print(f"{label}: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return runs


def t5_phase(torch, flash, paged):
    """Phase 13: examples/t5_seq2seq.yaml compiled and run by the port's
    launcher (t5_base at full width and depth, seq2seq_synthetic,
    adafactor, seq 512, global batch 64 in T5_ACCUM microbatches, remat
    dots, T5_STEPS steps): the forward kernel's launches split into the
    encoder's (non-causal) and the decoder self-attention's (causal),
    each backward once per attention layer and microbatch. Then t5_base
    served: the static engine over HTTP (streamed equals non-streamed),
    the continuous engine over T5_PROMPTS, and the first admission's
    decoder logits against the plain path. Returns each run's
    launches."""
    import shutil
    import tempfile

    import numpy as np

    from polyaxon_tpu_torch.models import t5
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import ServingServer, load_params

    label = "13. t5"
    t_phase = time.perf_counter()
    cfg = t5.CONFIGS["t5_base"]
    job = compile_example(T5_EXAMPLE, label, axes=("dp",),
                          runtime={"steps": T5_STEPS,
                                   "grad_accum_steps": T5_ACCUM,
                                   "log_every": 1})
    tmp = tempfile.mkdtemp(prefix="chip-smoke-t5-")
    try:
        _zero(flash, paged)
        torch.cuda.reset_peak_memory_stats()
        with _CausalSplit(flash) as split:
            emitted, outputs, launches, wall = launch_in_process(
                job, tmp, label)
        counts = _counts(flash, paged)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _check_emissions(label, emitted, T5_STEPS)
    per_stack = cfg.n_layers * T5_ACCUM * T5_STEPS
    # remat "dots" recomputes each forward once in the backward.
    want = {"fwd causal": 2 * per_stack, "fwd non-causal": 2 * per_stack,
            "bwd causal": per_stack, "bwd non-causal": per_stack}
    if split.counts != want or counts["flash_bwd_dq"] != 2 * per_stack \
            or counts != launches:
        fail(f"{label}: kernel calls {split.counts} (want {want}), "
             f"launches {counts}")
    for vals in emitted:
        print(f"{label} train step {vals['step']}: loss={vals['loss']:.5f} "
              f"grad_norm={vals['grad_norm']:.4f} step_ms="
              f"{vals['step_time_ms']:.1f} tokens_per_s="
              f"{vals['tokens_per_sec']:.1f}", flush=True)
    print(f"{label} training: params={outputs['param_count'] / 1e6:.1f}M "
          f"tokens_per_s={outputs['throughput']:.1f} (no MFU: the JAX "
          f"package derives none for t5) wall_s={wall:.1f} "
          f"max_memory_allocated_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} kernel calls "
          f"{split.counts} launches={counts}", flush=True)
    runs = [counts]
    torch.cuda.empty_cache()

    # Served: the static engine over a dense cache (the defaults).
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist()
               for n in T5_PROMPTS]
    _zero(flash, paged)
    with ServingServer("t5_base", seed=SEED, device="cuda") as srv:
        body = {"tokens": [prompts[2]], "max_new_tokens": T5_NEW_TOKENS}
        plain = _post_json(srv.url, body)["tokens"][0]
        streamed = _sse(srv.url, body)
        cfg, params = srv.engine.cfg, srv.engine.params
    counts = _counts(flash, paged)
    toks = [d["token"] for name, d in streamed if name == "token"]
    if len(plain) != T5_NEW_TOKENS or toks != plain:
        fail(f"{label}: static engine answered {plain}, streamed {toks}")
    if counts["flash_fwd"] <= 0:
        fail(f"{label}: the static engine launched {counts}")
    runs.append(counts)
    print(f"{label} static engine over HTTP: {len(plain)} tokens, streamed "
          f"equals non-streamed, launches {counts}", flush=True)

    eng = ContinuousBatchingEngine("t5_base", cfg, params, slots=8,
                                   device="cuda")
    try:
        _zero(flash, paged)
        _, outs, wall = _run_engine_mix(eng, prompts, T5_NEW_TOKENS)
        counts = _counts(flash, paged)
        stats = eng.stats()
    finally:
        eng.stop()
    _check_outs(f"{label} continuous", prompts, outs, T5_NEW_TOKENS,
                cfg.vocab_size)
    if counts["flash_fwd"] != cfg.n_layers * len(prompts):
        fail(f"{label} continuous: launches {counts}; the encoder's "
             f"non-causal forward must run once per layer and admission")
    runs.append(counts)
    print(f"{label} continuous engine: {len(prompts)} prompts (encoder "
          f"lengths {list(T5_PROMPTS)}) x {T5_NEW_TOKENS} tokens "
          f"wall_s={wall:.2f} decode_step_ms_median="
          f"{stats['decode_step_ms_median']:.2f} launches={counts}",
          flush=True)

    # The first admission's decoder logits, kernel path against plain.
    row = torch.tensor([prompts[0]], device="cuda")
    logits = {}
    for name, c in (("kernel", cfg),
                    ("plain", dataclasses.replace(cfg,
                                                  attention_impl="xla"))):
        pool = t5.cb_prefill(c, params, row, T5_NEW_TOKENS)
        lg, _ = t5.decode_step_ragged(
            c, params, pool, torch.tensor([t5.BOS_ID], device="cuda"),
            torch.tensor([0], device="cuda"))
        logits[name] = lg.float()
    rel = _rel(logits["kernel"], logits["plain"])
    if not torch.isfinite(logits["kernel"]).all() or rel > MODEL_REL_TOL:
        fail(f"{label}: first decoder logits kernel vs plain rel {rel} "
             f"(tol {MODEL_REL_TOL})")
    print(f"{label} first admission (encoder {T5_PROMPTS[0]} tokens): "
          f"decoder logits rel err {rel:.3e} same_argmax="
          f"{bool(logits['kernel'].argmax() == logits['plain'].argmax())} "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    del params
    torch.cuda.empty_cache()
    return runs


def other_families(torch, flash, paged):
    """Phase 14: bert_large (mlm_synthetic, seq 512, lion), vit_b16 (the
    runtime of examples/hyperband_vit.yaml at one trial's values),
    resnet50 (imagenet_synthetic, batch 64; its batch statistics must
    move) and mnist_cnn (examples/mnist.yaml at its defaults), each at
    full width and depth for a few steps with finite losses. These launch
    no kernel: bert and vit run einsum attention, as the reference's
    configs do, and convolutions are cuDNN's."""
    import shutil
    import tempfile

    from polyaxon_tpu_torch.runtime.checkpoint import load_tree
    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    label = "14."
    t_phase = time.perf_counter()
    lr = float(math.exp(-5.75))  # the middle of the sweep's log range
    jobs = [
        ("bert_large", {"kind": "jaxjob", "runtime": {
            "model": "bert_large", "dataset": "mlm_synthetic",
            "seq_len": 512, "global_batch_size": 8, "optimizer": "lion",
            "learning_rate": 1e-4, "steps": 4, "log_every": 1}}),
        ("vit_b16", compile_example(VIT_EXAMPLE, f"{label} vit_b16",
                                    params={"lr": lr, "num_epochs": 1},
                                    axes=("dp",),
                                    runtime={"log_every": 1})),
        ("resnet50", {"kind": "jaxjob", "runtime": {
            "model": "resnet50", "dataset": "imagenet_synthetic",
            "global_batch_size": 64, "steps": 4, "log_every": 1},
            "checkpointing": {"enabled": True, "intervalSteps": 100,
                              "asyncSave": False}}),
        ("mnist_cnn", compile_example(MNIST_EXAMPLE, f"{label} mnist_cnn",
                                      runtime={"log_every": 1})),
    ]
    for name, job in jobs:
        tmp = tempfile.mkdtemp(prefix="chip-smoke-family-")
        try:
            emitted = []
            _zero(flash, paged)
            t0 = time.perf_counter()
            result = run_torchjob(job, artifacts_dir=tmp, device="cuda",
                                  on_metrics=lambda s, v: emitted.append(
                                      dict(v, step=s)))
            wall = time.perf_counter() - t0
            counts = _counts(flash, paged)
            steps = job["runtime"]["steps"]
            _check_emissions(f"{label} {name}", emitted, steps)
            moved = ""
            if name == "resnet50":
                _, tree = load_tree(os.path.join(tmp, "checkpoints"),
                                    only="state")
                mean = tree["state"]["stem_bn"]["mean"]
                var = tree["state"]["stem_bn"]["var"]
                if not (mean.abs().max() > 0 and (var - 1).abs().max() > 0):
                    fail(f"{label} resnet50: batch statistics did not move")
                moved = (f" stem_bn mean |max| {mean.abs().max():.3e}, var "
                         f"in [{var.min():.3e}, {var.max():.3e}] (init 0 "
                         f"and 1);")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if any(counts.values()):
            fail(f"{label} {name} launched {counts}")
        print(f"{label} {name}: steps={result.steps} losses "
              f"{[round(v['loss'], 4) for v in emitted]}{moved} "
              f"{result.unit}_per_s={result.throughput:.1f} wall_s="
              f"{wall:.1f}; launches no kernel ({counts})", flush=True)
        torch.cuda.empty_cache()
    print(f"{label} phase_s={time.perf_counter() - t_phase:.1f}", flush=True)


def lora_depth(torch, llama, free_disk: float, free_host: float,
               rank: int, label: str) -> int:
    """llama3_8b's depth for the LoRA phase: LORA_LAYERS, cut further
    only if one checkpoint (the f32 base, the adapters and their adamw
    moments) does not fit in the free disk or DRILL_DISK_BUDGET, or its
    host snapshot in the available host memory less DRILL_HOST_MARGIN."""
    from polyaxon_tpu_torch.models import lora

    cfg = llama.CONFIGS["llama3_8b"]
    meta = llama.init(cfg, torch.Generator(), device="meta")["params"]
    per_layer = sum(t.numel() for t in meta["layers"].values()) \
        // cfg.n_layers
    other = sum(t.numel() for t in _leaves(meta)) - per_layer * cfg.n_layers
    adapters = sum(rank * (t.shape[-2] + t.shape[-1])
                   for name, t in meta["layers"].items()
                   if name in lora.DEFAULT_TARGETS) // cfg.n_layers

    def state_bytes(layers):
        return 4 * (other + per_layer * layers) + 12 * adapters * layers

    def fits(layers):
        return (state_bytes(layers) <= min(free_disk, DRILL_DISK_BUDGET)
                and state_bytes(layers) <= free_host - DRILL_HOST_MARGIN)

    layers = min(cfg.n_layers, LORA_LAYERS)
    while layers > 1 and not fits(layers):
        layers -= 1
    print(f"{label}: one checkpoint of {state_bytes(layers) / 1e9:.2f} GB "
          f"at {layers} of {cfg.n_layers} layers; disk free "
          f"{free_disk / 1e9:.1f} GB (budget {DRILL_DISK_BUDGET / 1e9:.1f} "
          f"GB), host available {free_host / 1e9:.1f} GB"
          + ("" if layers == cfg.n_layers else
             f"; cut: depth {cfg.n_layers} -> {layers}, width kept"),
          flush=True)
    return layers


def lora_phase(torch, llama, flash, paged):
    """Phase 15: the runtime section of examples/lora_finetune.yaml
    (llama3_8b at full width, rank 16, alpha 32, seq 4096, flash, remat
    dots) for LORA_STEPS steps of LORA_BATCH rows in microbatches of 1,
    one checkpoint, depth cut by ``lora_depth``. Only the adapters
    change (the base equals its seeded init), the optimizer holds state
    for them alone, the backward kernels launch per layer and
    microbatch. Then ``ServingServer("llama3_8b", checkpoint=...)``
    merges the adapters from the checkpoint's ``_meta`` and answers one
    request, and its first logits are held against the plain path over
    the merged weights. Returns each run's launches."""
    import shutil
    import tempfile

    import numpy as np

    from polyaxon_tpu_torch.models import lora
    from polyaxon_tpu_torch.runtime import tiers
    from polyaxon_tpu_torch.runtime.checkpoint import (load_tree,
                                                       read_manifest)
    from polyaxon_tpu_torch.serving.server import ServingServer
    from polyaxon_tpu_torch.tracking.systemmetrics import meminfo

    label = "15. lora"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-lora-")
    try:
        runtime = {"steps": LORA_STEPS, "global_batch_size": LORA_BATCH,
                   "grad_accum_steps": LORA_BATCH, "log_every": 1}
        rank = 16
        layers = lora_depth(torch, llama, shutil.disk_usage(tmp).free,
                            meminfo()["MemAvailable"], rank, label)
        if layers < llama.CONFIGS["llama3_8b"].n_layers:
            runtime["n_layers"] = layers
        job = compile_example(LORA_EXAMPLE, label, axes=("fsdp",),
                              runtime=runtime)
        rt = job["runtime"]
        if (rt["lora_rank"], rt["lora_alpha"]) != (rank, 32.0):
            fail(f"{label}: the example's LoRA settings changed: {rt}")
        _zero(flash, paged)
        torch.cuda.reset_peak_memory_stats()
        emitted, outputs, launches, wall = launch_in_process(job, tmp, label)
        counts = _counts(flash, paged)
        peak = torch.cuda.max_memory_allocated() / 1e9
        tiers.TIER0.clear()
        torch.cuda.empty_cache()
        _check_emissions(label, emitted, LORA_STEPS)
        want = layers * LORA_BATCH * LORA_STEPS
        if counts != launches or counts != {
                "flash_fwd": 2 * want, "flash_bwd_dkdv": want,
                "flash_bwd_dq": want, "paged_decode": 0}:
            fail(f"{label}: launches {counts}; each backward kernel must "
                 f"run {want} times (layers x microbatches x steps), the "
                 f"forward twice as often (remat dots)")
        for vals in emitted:
            print(f"{label} step {vals['step']}: loss={vals['loss']:.5f} "
                  f"grad_norm={vals['grad_norm']:.4e} step_ms="
                  f"{vals['step_time_ms']:.1f} tokens_per_s="
                  f"{vals['tokens_per_sec']:.1f}", flush=True)
        print(f"{label} training: params={outputs['param_count'] / 1e9:.3f}B "
              f"(base and adapters) tokens_per_s="
              f"{outputs['throughput']:.1f} wall_s={wall:.1f} "
              f"max_memory_allocated_GB={peak:.2f} launches={counts}",
              flush=True)

        # The checkpoint: optimizer state for the adapters alone, the base
        # as initialized, the adapters moved (B starts at zero).
        ckdir = os.path.join(tmp, "checkpoints")
        step = _store_steps(ckdir)[-1]
        entries = read_manifest(ckdir, step)["leaves"]
        shapes = {e["path"]: tuple(e.get("shape", ())) for e in entries}
        adapters = [s for p, s in shapes.items()
                    if p.startswith("params/lora/") and "_meta" not in p]
        moments = {k: [s for p, s in shapes.items()
                       if p.startswith(f"opt_state/{k}/")]
                   for k in ("mu", "nu")}
        if sorted(moments["mu"]) != sorted(adapters) \
                or sorted(moments["nu"]) != sorted(adapters):
            fail(f"{label}: optimizer state {moments} is not the adapters' "
                 f"{adapters}")
        base_cfg = dataclasses.replace(llama.CONFIGS["llama3_8b"],
                                       n_layers=layers)
        init = llama.init(base_cfg, torch.Generator(device="cuda").manual_seed(
            rt.get("seed", 0)), device="cuda")["params"]
        for path in ("embed", "layers/wq"):
            _, tree = load_tree(ckdir, only=f"params/base/{path}")
            node = tree["params"]["base"]
            ref = init
            for key in path.split("/"):
                node, ref = node[key], ref[key]
            if not torch.equal(node.cuda(), ref):
                fail(f"{label}: the base's {path} changed in training")
        del init
        _, tree = load_tree(ckdir, only="params/lora")
        ab = lora._adapters_by_path(lora.split_meta(
            tree["params"]["lora"])[0])
        if not all(v["b"].abs().max() > 0 for v in ab.values()):
            fail(f"{label}: an adapter's B stayed at zero")
        print(f"{label} checkpoint step {step}: {len(adapters)} adapter "
              f"tensors with adamw moments, {len(entries)} leaves; the base "
              f"(embed, wq) equals its seeded init, every B moved",
              flush=True)
        torch.cuda.empty_cache()

        # Served: the adapters merged at load from the checkpoint's _meta.
        name = "llama3_8b"
        if layers < llama.CONFIGS[name].n_layers:
            name = f"llama3_8b_{layers}l"
            llama.CONFIGS[name] = base_cfg
        rng = np.random.default_rng(SEED + 6)
        prompt = rng.integers(0, base_cfg.vocab_size, 300).tolist()
        t0 = time.perf_counter()
        _zero(flash, paged)
        with ServingServer(name, checkpoint=ckdir, device="cuda") as srv:
            t_load = time.perf_counter() - t0
            out = _post_json(srv.url, {"tokens": [prompt],
                                       "max_new_tokens": 8})
            counts_srv = _counts(flash, paged)
            cfg, params = srv.engine.cfg, srv.engine.params
            if len(out["tokens"][0]) != 8 or counts_srv["flash_fwd"] <= 0:
                fail(f"{label}: serving answered {out}, launches "
                     f"{counts_srv}")
            print(f"{label} served {name} from the checkpoint (adapters "
                  f"merged at load, alpha and rank from _meta) in "
                  f"{t_load:.1f}s: {out['tokens'][0]}, launches "
                  f"{counts_srv}", flush=True)
            compare_first_admission(torch, llama, cfg, params, prompt)
            del params
    finally:
        tiers.TIER0.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"{label} phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return counts, counts_srv


def families(torch, llama, flash, paged):
    """Phases 11-15; returns each run's launches."""
    t0 = time.perf_counter()
    runs = [moe_training(torch, flash, paged)]
    moe_parity(torch, flash)
    runs += moe_serving(torch, llama, flash, paged)
    runs += t5_phase(torch, flash, paged)
    other_families(torch, flash, paged)
    runs += lora_phase(torch, llama, flash, paged)
    print(f"phases 11-15: {time.perf_counter() - t0:.1f}s", flush=True)
    return runs


def chaos_restore(torch, llama):
    """Phase 16a: two steps of llama3_1b's full-width f32 params saved by
    a ``TieredCheckpointManager`` on the card, then restored under
    ``checkpoint/corrupt_latest`` (the older step, the newer skipped,
    from tier 1 or 2) and under ``tier0-loss/drop`` (from the store);
    each restore's leaves held against its step's manifest CRC-32s and
    counted once in ``polyaxon_checkpoint_restore_seconds{tier}``, the
    ``chaos.<seam>`` windows closed in the history ring."""
    import shutil
    import tempfile

    from polyaxon_tpu_torch import chaos
    from polyaxon_tpu_torch.obs import history as obs_history
    from polyaxon_tpu_torch.obs import metrics as obs_metrics
    from polyaxon_tpu_torch.runtime import checkpoint as ck
    from polyaxon_tpu_torch.runtime import tiers

    label = "16a. chaos restore"
    t_phase = time.perf_counter()
    cfg = llama.CONFIGS["llama3_1b"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init(cfg, gen, device="cuda")["params"]
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-chaos-")
    mgr = ck.TieredCheckpointManager(
        os.path.join(tmp, "ckpt"),
        ck.CheckpointSpec(async_save=False, max_to_keep=3))

    def restore_samples():
        fam = obs_metrics.checkpoint_restore_hist().snapshot()["series"]
        return {tier: s["count"] for tier, s in fam.items()}

    try:
        for step in (1, 2):
            with torch.no_grad():
                params["final_norm"].add_(1.0)  # the two steps differ
            mgr.save(step, {"step": step, "params": params}, force=True)
            mgr.wait()
        saves = {t: [round(x, 3) for x in v]
                 for t, v in mgr.save_seconds.items()}
        out = []
        for fault, want_step, want_skip, tiers_ok in (
                ({"seam": "checkpoint", "op": "corrupt_latest"}, 1, [2],
                 (tiers.TIER_LOCAL, tiers.TIER_STORE)),
                ({"seam": "tier0-loss", "op": "drop"}, 1, [],
                 (tiers.TIER_STORE,))):
            before = restore_samples()
            chaos.install(chaos.ChaosPlan.from_dict({"faults": [fault]}))
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state = mgr.restore({"step": 0, "params": params})
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                fired = chaos.active_plan().done
            finally:
                chaos.uninstall()
            tier = mgr.last_restore_tier
            after = restore_samples()
            grew = {t: after.get(t, 0) - before.get(t, 0) for t in after}
            manifest = ck.read_manifest(mgr.directory, want_step)
            crcs_ok = device_crcs(torch, state) == [
                e["crc32"] for e in manifest["leaves"]]
            seam = fault["seam"]
            if (not fired or state["step"] != want_step
                    or mgr.last_restore_skipped != want_skip
                    or tier not in tiers_ok or not crcs_ok
                    or {t: n for t, n in grew.items() if n} != {tier: 1}):
                fail(f"{label}: {seam}: fired {fired}, step "
                     f"{state['step']} (want {want_step}), skipped "
                     f"{mgr.last_restore_skipped} (want {want_skip}), tier "
                     f"{tier} (want {tiers_ok}), CRC-32s equal "
                     f"{crcs_ok}, restore samples added {grew}")
            out.append(f"{seam}: step {state['step']} from tier {tier} in "
                       f"{seconds:.3f}s (skipped {mgr.last_restore_skipped})")
        windows = {w["name"]: w for w in
                   obs_history.default_history().windows()}
        for seam in ("checkpoint", "tier0-loss"):
            w = windows.get(f"chaos.{seam}")
            if w is None or w.get("end") is None:
                fail(f"{label}: no closed chaos.{seam} window in the "
                     f"history ring: {sorted(windows)}")
    finally:
        mgr.close()
        tiers.TIER0.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    torch.cuda.empty_cache()
    print(f"{label}: llama3_1b params {nbytes / 1e9:.2f} GB f32, two steps "
          f"saved (commit seconds by tier {saves}); {'; '.join(out)}; "
          f"restore samples by tier {restore_samples()}; windows "
          f"chaos.checkpoint and chaos.tier0-loss closed; phase_s="
          f"{time.perf_counter() - t_phase:.1f}", flush=True)


# Phase 17: examples/longcontext_ring.yaml on the card (dp2 x cp8 cut to
# one device; its global batch of 16 rows to 1; 1,000 steps to 4); the
# ring's schedule at cp = 2, 4 and 8 and Ulysses' head split at n = 4,
# replayed in one process at the example's row.
LONGCTX_EXAMPLE = "examples/longcontext_ring.yaml"
LONGCTX_STEPS = 4
LONGCTX_SEQ = 32_768
RING_REPLAY_CPS = (2, 4, 8)
RING_PLAIN_SEQ = 4096     # the replays also held against the plain path
ULYSSES_N = 4


def longcontext_training(torch, flash, paged):
    """Phase 17a: the example compiled by the port with the gpu preset
    and run by its launcher with a one-process bootstrap env: a real
    one-rank NCCL group, the parameters DTensors on a one-device
    {dp: 1, cp: 1} mesh, llama3_1b at full width and depth, seq 32,768,
    ``attention_impl: ring``, ``remat: full``, ``loss_chunk`` 256. Per
    step and layer the zigzag at cp=1 runs three flash blocks (the two
    half-row causal diagonals and the non-causal hi-lo block) and one
    merge, the forward twice under full remat: 6 forward and 3 of each
    backward kernel. Returns the launches."""
    import shutil
    import tempfile

    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.parallel import bootstrap

    label = "17a. longcontext ring"
    t_phase = time.perf_counter()
    layers = llama.CONFIGS["llama3_1b"].n_layers
    job = compile_example(LONGCTX_EXAMPLE, label, axes=("dp", "cp"),
                          runtime={"steps": LONGCTX_STEPS,
                                   "global_batch_size": 1, "log_every": 1})
    rt = job["runtime"]
    if (rt["seq_len"], rt["attention_impl"], rt["remat"], rt["model"]) != (
            LONGCTX_SEQ, "ring", "full", "llama3_1b"):
        fail(f"{label}: the example's runtime changed: {rt}")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ring-")
    env = {bootstrap.ENV_NUM_PROCESSES: "1", bootstrap.ENV_PROCESS_ID: "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        _zero(flash, paged)
        torch.cuda.reset_peak_memory_stats()
        emitted, outputs, launches, wall = launch_in_process(job, tmp, label)
        counts = _counts(flash, paged)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    import torch.distributed as dist

    if dist.is_initialized():
        fail(f"{label}: the launcher left its process group behind")
    _check_emissions(label, emitted, LONGCTX_STEPS)
    per_step = {"flash_fwd": 6 * layers, "flash_bwd_dkdv": 3 * layers,
                "flash_bwd_dq": 3 * layers, "paged_decode": 0}
    want = {k: v * LONGCTX_STEPS for k, v in per_step.items()}
    if counts != launches or counts != want:
        fail(f"{label}: launches {counts} (launcher's line {launches}); "
             f"want {want} ({per_step} per step)")
    for vals in emitted:
        print(f"{label} step {vals['step']}: loss={vals['loss']:.5f} "
              f"grad_norm={vals['grad_norm']:.4f} step_ms="
              f"{vals['step_time_ms']:.1f} tokens_per_s="
              f"{vals['tokens_per_sec']:.1f} mfu={vals.get('mfu')}",
              flush=True)
    print(f"{label}: llama3_1b {layers} layers, seq {LONGCTX_SEQ} x 1 row "
          f"(cuts: mesh dp2 x cp8 to one H100, global batch 16 to 1, "
          f"steps 1000 to {LONGCTX_STEPS}); tokens_per_s="
          f"{outputs['throughput']:.1f} step_ms="
          f"{emitted[-1]['step_time_ms']:.1f} first_step_s="
          f"{outputs['compile_time_s']:.1f} wall_s={wall:.1f} "
          f"max_memory_allocated_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches per step "
          f"{per_step} phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return counts


def ring_parity(torch, llama):
    """Phase 17b: one 32,768-token row of llama3_1b (full width and
    depth, remat full) through ``attention_impl="ring"`` on a one-device
    {dp: 1, cp: 1} mesh against ``"flash"``: the same function,
    decomposed into half-row blocks and merged. The loss to
    TRAIN_LOSS_REL_TOL and every leaf's gradient to TRAIN_GRAD_REL_TOL
    (relative Frobenius norm), phase 5's tolerances."""
    from polyaxon_tpu_torch.parallel import bootstrap
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh
    from polyaxon_tpu_torch.runtime.data import lm_synthetic

    label = "17b. ring parity"
    t_phase = time.perf_counter()
    base = dataclasses.replace(llama.CONFIGS["llama3_1b"], remat="full")
    params = llama.init(base, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")["params"]
    for t in _leaves(params):
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(lm_synthetic(
        1, seq_len=LONGCTX_SEQ, vocab_size=base.vocab_size,
        seed=SEED + 2)).items()}

    def run(impl):
        cfg = dataclasses.replace(base, attention_impl=impl)
        loss, _, _ = llama.apply(cfg, {"params": params, "state": {}}, batch)
        loss.backward()
        grads = {}
        for path, t in _named_leaves(params):
            grads[path] = t.grad.float()
            t.grad = None
        torch.cuda.synchronize()
        return loss.item(), grads

    with bootstrap.process_group("cuda"):
        mesh = build_mesh(axes={"dp": 1, "cp": 1}, device_type="cuda")
        with use_mesh(mesh):
            ring_loss, ring = run("ring")
    flash_loss, want = run("flash")
    loss_rel = abs(ring_loss - flash_loss) / abs(flash_loss)
    rels = {k: ((g - want[k]).norm() / want[k].norm()).item()
            for k, g in ring.items()}
    worst = max(rels, key=rels.get)
    print(f"{label}: loss ring={ring_loss:.6f} flash={flash_loss:.6f} "
          f"rel={loss_rel:.3e}; grad rel over {len(rels)} leaves: worst "
          f"{worst}={rels[worst]:.3e}, median "
          f"{sorted(rels.values())[len(rels) // 2]:.3e} (tolerances "
          f"TRAIN_LOSS_REL_TOL={TRAIN_LOSS_REL_TOL}, TRAIN_GRAD_REL_TOL="
          f"{TRAIN_GRAD_REL_TOL}) phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    if not all(map(math.isfinite, rels.values())) or \
            loss_rel > TRAIN_LOSS_REL_TOL or rels[worst] > TRAIN_GRAD_REL_TOL:
        fail(f"{label}: loss rel {loss_rel}, grad rel {rels}")
    del params, ring, want


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _named_leaves(v, path)
        else:
            yield path, v


def _hold_replay(torch, label, got, want, bwd=False):
    """Fail unless ``got`` agrees with ``want`` (forward: the flash
    output tolerances; backward: the gradient tolerances)."""
    for name, g, w in zip(("o",) if not bwd else ("dq", "dk", "dv"),
                          got, want):
        if not torch.isfinite(g).all():
            fail(f"{label}: non-finite {name}")
        ok = _bwd_close(g, w) if bwd else close(g, w)
        if not ok:
            fail(f"{label}: {name} max abs err "
                 f"{(g.float() - w.float()).abs().max().item()}, max |want| "
                 f"{w.float().abs().max().item()}")
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def replays(torch, flash):
    """Phases 17c and 17d: at llama3_1b's row (B=1, S=32,768, 32:8 heads,
    D=64, bf16), every rank's zigzag schedule at cp = 2, 4 and 8
    (``ring.replay_zigzag``: the package's per-rank diagonal and step
    functions, each permute replaced by the rotation it performs) and
    Ulysses' n = 4 head split (``ulysses.replay_ulysses``), forward and
    backward, through the flash kernels, against ``flash_attention`` on
    the whole row (the outputs to OUT_ATOL/OUT_RTOL, the gradients to
    BWD_ATOL_REL/BWD_RTOL); at S = RING_PLAIN_SEQ also against the plain
    versions of the whole row."""
    from polyaxon_tpu_torch.ops.ring import replay_zigzag
    from polyaxon_tpu_torch.ops.ulysses import replay_ulysses

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    D, H, KV = 64, 32, 8

    def grads(fn, q, k, v, do):
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = fn(q, k, v)
        return (o,), torch.autograd.grad(o, (q, k, v), do)

    def whole(q, k, v):
        return flash.flash_attention(q, k, v, causal=True)

    def plain(q, k, v):  # the plain forward, differentiated by autograd
        return flash.flash_fwd_plain(q, k, v, causal=True,
                                     scale=D ** -0.5)[0]

    for S in (LONGCTX_SEQ, RING_PLAIN_SEQ):
        q, k, v, do = (torch.randn(1, S, n, D, generator=gen, device="cuda",
                                   dtype=torch.bfloat16)
                       for n in (H, KV, KV, H))
        refs = {"flash": grads(whole, q, k, v, do)}
        if S == RING_PLAIN_SEQ:
            refs["plain"] = grads(plain, q, k, v, do)
        cases = [(f"17c. zigzag replay cp={cp}",
                  functools.partial(replay_zigzag, cp=cp))
                 for cp in RING_REPLAY_CPS]
        cases.append((f"17d. ulysses replay n={ULYSSES_N}",
                      functools.partial(replay_ulysses, n=ULYSSES_N,
                                        attn_impl="flash")))
        for label, fn in cases:
            (o,), g = grads(fn, q, k, v, do)
            errs = []
            for ref, ((ro,), rg) in refs.items():
                errs.append(f"vs {ref}: o "
                            f"{_hold_replay(torch, label, (o,), (ro,)):.3e}"
                            f" grads "
                            f"{_hold_replay(torch, label, g, rg, True):.3e}")
            ms = time_ms(lambda: grads(fn, q, k, v, do), reps=3, warmup=1)
            print(f"{label} S={S} B=1 H={H} KV={KV} D={D}: forward+backward "
                  f"ms={ms:.2f} (whole-row flash "
                  f"{time_ms(lambda: grads(whole, q, k, v, do), reps=3, warmup=1):.2f}); "
                  f"max abs err {'; '.join(errs)}", flush=True)
        if S == LONGCTX_SEQ:
            ulysses_dispatch(torch, flash, q, k, v, refs["flash"][0][0])
        del q, k, v, do, refs
        torch.cuda.empty_cache()


def ulysses_dispatch(torch, flash, q, k, v, want):
    """Phase 17d: ``dot_product_attention(impl="ulysses")`` on the card,
    as a job with ``attention_impl: ulysses`` calls it (a one-rank NCCL
    group, a {dp: 1, cp: 1} mesh): one flash forward launch, the output
    held against ``flash_attention`` on the whole row."""
    from polyaxon_tpu_torch.ops.attention import dot_product_attention
    from polyaxon_tpu_torch.parallel import bootstrap
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh

    label = "17d. ulysses dispatch"
    with bootstrap.process_group("cuda"):
        mesh = build_mesh(axes={"dp": 1, "cp": 1}, device_type="cuda")
        with use_mesh(mesh), torch.no_grad():
            before = flash.launches
            o = dot_product_attention(q, k, v, causal=True, impl="ulysses")
            launched = flash.launches - before
    if launched != 1:
        fail(f"{label}: {launched} flash forward launches, want 1")
    err = _hold_replay(torch, label, (o,), (want,))
    print(f"{label}: impl=ulysses on one rank, flash forward launches "
          f"{launched}, max abs err vs whole-row flash {err:.3e}",
          flush=True)


def context_parallel(torch, llama, flash, paged):
    """Phase 17; returns 17a's launches."""
    t0 = time.perf_counter()
    counts = longcontext_training(torch, flash, paged)
    torch.cuda.empty_cache()
    ring_parity(torch, llama)
    torch.cuda.empty_cache()
    replays(torch, flash)
    print(f"phase 17: {time.perf_counter() - t0:.1f}s", flush=True)
    return counts


# Phase 18: tensor, expert and pipeline parallelism replayed on one card.
TP_REPLAY_NS = (2, 4, 8)
TP_MODEL = "llama3_8b"
TP_SEQ = 4096
EP_REPLAY_NS = (2, 4, 8)
EP_BATCH, EP_SEQ = 4, 2048   # moe_8x200m's training microbatch
PP_MODEL = "llama3_1b"
PP_STAGES = 4
PP_MICRO = 4
PP_SEQ = 4096
ENTRY_STEPS = 2
# Phase 18d's spec: llama3_1b on a mesh of every new axis at one device.
ENTRY_SPEC = """version: 1.1
kind: operation
name: llama-model-parallel-axes
component:
  name: llama-mp
  run:
    kind: jaxjob
    topology: {accelerator: v5e, topology: 2x2, slices: 1}
    mesh:
      axes: {dp: 1, tp: 1, pp: 1, ep: 1}
    runtime:
      model: llama3_1b
      dataset: lm_synthetic
      steps: %d
      seq_len: 4096
      global_batch_size: 1
      attention_impl: flash
      remat: dots
      pipeline_stages: 1
      log_every: 1
""" % ENTRY_STEPS


def _tp_shard(cfg, layer: dict, n: int, j: int) -> dict:
    """tp rank ``j``'s views of one layer's weights (the rule tables'
    placements): column slices of the heads and mlp projections, row
    slices of ``wo`` and ``w_down``, the norms whole (and K/V whole where
    the KV heads do not split, as the package gathers them)."""
    cols = ("wq", "w_gate", "w_up") + (
        ("wk", "wv") if cfg.n_kv_heads % n == 0 else ())
    out = {}
    for key, w in layer.items():
        if key in cols:
            c = w.shape[-1] // n
            out[key] = w[:, j * c:(j + 1) * c]
        elif key in ("wo", "w_down"):
            r = w.shape[0] // n
            out[key] = w[j * r:(j + 1) * r]
        else:
            out[key] = w
    return out


def _grad_rels(torch, got: dict, want: dict) -> dict:
    """Relative Frobenius error of each gradient (``want`` may be held on
    the host: each leaf comes to the device in turn)."""
    rels = {}
    for k, g in got.items():
        w = want[k].to(g.device).float()
        rels[k] = ((g.float() - w).norm() / w.norm()).item()
        del w
    return rels


def _hold_training(label, loss, want_loss, rels) -> str:
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    worst = max(rels, key=rels.get)
    if not all(map(math.isfinite, rels.values())) or \
            loss_rel > TRAIN_LOSS_REL_TOL or rels[worst] > TRAIN_GRAD_REL_TOL:
        fail(f"{label}: loss rel {loss_rel}, grad rel {rels}")
    return (f"loss rel {loss_rel:.3e}, grad rel over {len(rels)} leaves "
            f"worst {worst}={rels[worst]:.3e}")


def tp_replay(torch, llama, flash):
    """Phase 18a: llama3_8b (random bf16 weights from SEED, full width
    and depth, flash) on one TP_SEQ-token row, forward and backward, and
    every tp = 2, 4, 8 split of it in this process: each rank's
    vocab-parallel embedding rows, its column-parallel q/k/v and
    gate/up projections, its local heads through ``flash_attention``
    (8:2 at tp4) and its row-parallel ``wo``/``w_down`` partials, summed
    in place of the all-reduce (``parallel.tensor.replay_tp`` around the
    package's ``_attn_out`` and ``_mlp_out``, each rank's block
    recomputed in the backward), then the vocab-parallel
    cross entropy of its head columns (``replay_vocab_ce``). Held
    against the unsplit model's ``apply``: the loss to
    TRAIN_LOSS_REL_TOL and every leaf's gradient to TRAIN_GRAD_REL_TOL."""
    from polyaxon_tpu_torch.models.common import shift_right
    from polyaxon_tpu_torch.parallel import tensor
    from polyaxon_tpu_torch.runtime.data import lm_synthetic

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama.CONFIGS[TP_MODEL],
                              attention_impl="flash")
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda", param_dtype=torch.bfloat16)["params"]
    for t in _leaves(params):
        t.requires_grad_(True)
    tokens = torch.from_numpy(next(lm_synthetic(
        1, seq_len=TP_SEQ, vocab_size=cfg.vocab_size,
        seed=SEED + 4))["tokens"]).cuda().long()

    def grads_of(loss):
        loss.backward()
        out = {}
        for path, t in _named_leaves(params):
            out[path] = t.grad
            t.grad = None
        torch.cuda.synchronize()
        return loss.item(), out

    want_loss, want = grads_of(llama.apply(
        cfg, {"params": params, "state": {}}, {"tokens": tokens})[0])
    # The unsplit gradients wait on the host: 16 GB of weights, their
    # gradients and a split pass's activations fill the card.
    want = {k: g.to("cpu") for k, g in want.items()}
    inputs = shift_right(tokens)
    positions = llama._positions(1, TP_SEQ, "cuda")
    V = cfg.vocab_size
    for n in TP_REPLAY_NS:
        t0 = time.perf_counter()
        rows = V // n
        x = tensor.replay_tp(
            lambda table: llama._embed(cfg, {"embed": table}, inputs,
                                       cfg.dtype), n,
            lambda j: (params["embed"][j * rows:(j + 1) * rows],))
        # Each rank's block is recomputed in the backward: the n ranks'
        # replicated norms would not fit beside the weights at tp8.
        for layer in llama._layers(params):
            x = x + tensor.replay_tp(
                functools.partial(llama._attn_out, cfg), n,
                lambda j: (x, _tp_shard(cfg, layer, n, j), positions),
                remat=True)
            x = x + tensor.replay_tp(
                functools.partial(llama._mlp_out, cfg), n,
                lambda j: (x, _tp_shard(cfg, layer, n, j)), remat=True)
        x = llama._norm(cfg, x, params["final_norm"])
        head = params["lm_head"]
        nll, _ = tensor.replay_vocab_ce(
            [(x @ head[:, j * rows:(j + 1) * rows]).float()
             for j in range(n)], tokens)
        loss, got = grads_of(nll.mean())
        held = _hold_training(f"18a. tp replay tp={n}", loss, want_loss,
                              _grad_rels(torch, got, want))
        print(f"18a. tp replay tp={n}: {TP_MODEL} {cfg.n_layers} layers "
              f"(no depth cut; the unsplit gradients held on the host), "
              f"1 x {TP_SEQ} tokens, {cfg.n_heads // n}:"
              f"{cfg.n_kv_heads // n} heads per rank, D={cfg.head_dim}; loss "
              f"{loss:.6f} vs unsplit {want_loss:.6f}; {held}; "
              f"fwd+bwd_s={time.perf_counter() - t0:.2f}", flush=True)
        del got, x, nll
    del params, want
    torch.cuda.empty_cache()
    print(f"18a: {time.perf_counter() - t_phase:.1f}s", flush=True)


def ep_replay(torch, flash):
    """Phase 18b: moe_8x200m's training microbatch (EP_BATCH x EP_SEQ
    tokens, D=1024, 8 experts, top-2, bf16; layer 0's weights from SEED,
    the tokens random) through the ragged dispatch at ep = 2, 4 and 8,
    every rank's send buffers built in this process and each all-to-all
    done as the transpose it performs (``moe.replay_ep``), forward and
    backward, against the ep = 1 dispatch at no-drop capacity (8.0), the
    routing replayed from the ep = 1 run where a rounding flips a
    near-tie (``_Routing``): the output to OUT_ATOL/OUT_RTOL, the router
    aux to TRAIN_LOSS_REL_TOL, the gradients to TRAIN_GRAD_REL_TOL. At
    the default capacity (1.25) prints the drops per ep."""
    from polyaxon_tpu_torch.models import moe

    t_phase = time.perf_counter()
    base = dataclasses.replace(moe.CONFIGS["moe_8x200m"], n_layers=1)
    params = moe.init(base, torch.Generator(device="cuda").manual_seed(SEED),
                      device="cuda", param_dtype=torch.bfloat16)["params"]
    layer = {k: v[0].detach().requires_grad_(True)
             for k, v in params["layers"].items()
             if k in ("router", "w_gate", "w_up", "w_down")}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x = torch.randn(EP_BATCH * EP_SEQ, base.dim, generator=gen,
                    device="cuda", dtype=torch.bfloat16).requires_grad_(True)
    do = torch.randn(x.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    weights = (layer["router"], layer["w_gate"], layer["w_up"],
               layer["w_down"])
    leaves = (x, *weights)

    def run(fn):
        out, aux = fn()
        grads = torch.autograd.grad((out.float() * do.float()).sum() + aux,
                                    leaves)
        torch.cuda.synchronize()
        return out.detach(), aux.item(), grads

    cfg = dataclasses.replace(base, capacity_factor=8.0)
    with _Routing(torch, moe) as rec:
        want_out, want_aux, want_g = run(
            lambda: moe._moe_ragged_sharded(cfg, x, *weights))
    for n in EP_REPLAY_NS:
        t0 = time.perf_counter()
        t_loc = x.shape[0] // n
        replay = [rec.calls[0][i * t_loc:(i + 1) * t_loc] for i in range(n)]
        with _Routing(torch, moe, replay=replay) as routed:
            out, aux, g = run(lambda: moe.replay_ep(cfg, x, *weights, n))
        label = f"18b. ep replay ep={n}"
        err = _hold_replay(torch, label, (out,), (want_out,))
        aux_rel = abs(aux - want_aux) / abs(want_aux)
        rels = {name: ((a.float() - b.float()).norm()
                       / b.float().norm()).item()
                for name, a, b in zip(("x", "router", "w_gate", "w_up",
                                       "w_down"), g, want_g)}
        if aux_rel > TRAIN_LOSS_REL_TOL or \
                max(rels.values()) > TRAIN_GRAD_REL_TOL:
            fail(f"{label}: aux rel {aux_rel}, grad rel {rels}")
        drops = {}
        with torch.no_grad():
            moe.replay_ep(base, x, *weights, n, drops)
        print(f"{label}: {EP_BATCH}x{EP_SEQ} tokens, {base.n_experts // n} "
              f"experts per rank; capacity 8.0: out max abs err {err:.3e}, "
              f"aux rel {aux_rel:.3e}, grad rel "
              f"{ {k: float(f'{v:.3e}') for k, v in rels.items()} }, routing "
              f"flips replayed {sum(routed.flips)}; capacity "
              f"{base.capacity_factor}: dropped pairs {drops}; "
              f"fwd+bwd_s={time.perf_counter() - t0:.2f}", flush=True)
    del params, layer, x
    torch.cuda.empty_cache()
    print(f"18b: {time.perf_counter() - t_phase:.1f}s", flush=True)


def pp_replay(torch, llama, flash):
    """Phase 18c: llama3_1b's layers (full width and depth, bf16 weights
    from SEED, flash, remat full) on PP_MICRO rows of PP_SEQ tokens as a
    PP_STAGES-stage GPipe schedule replayed in this process
    (``pipeline.replay_pipeline`` over the package's ``stage_fn``), single-
    and double-buffered, forward and backward, against the unpipelined
    layers: the output to OUT_ATOL/OUT_RTOL, the gradients of the input
    and every layer leaf to TRAIN_GRAD_REL_TOL; the two schedules'
    outputs equal bit for bit."""
    from polyaxon_tpu_torch.parallel.pipeline import (replay_pipeline,
                                                      stack_stages)

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(llama.CONFIGS[PP_MODEL],
                              attention_impl="flash", remat="full")
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda", param_dtype=torch.bfloat16)["params"]
    layers = params["layers"]
    for t in _leaves(layers):
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    x = torch.randn(PP_MICRO, PP_SEQ, cfg.dim, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_(True)
    do = torch.randn(x.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    body = llama._layer_body(cfg)
    leaves = [x, *(t for _, t in _named_leaves(layers))]
    names = ["x", *(p for p, _ in _named_leaves(layers))]

    def run(fn):
        out = fn()
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        return out.detach(), dict(zip(names, grads))

    def unpiped():
        return llama.stage_fn(body)(layers, x)

    want_out, want = run(unpiped)
    outs = {}
    for double in (False, True):
        t0 = time.perf_counter()
        label = f"18c. pp replay {'double' if double else 'single'}"
        out, got = run(lambda: replay_pipeline(
            llama.stage_fn(body), stack_stages(layers, PP_STAGES), x,
            n_microbatches=PP_MICRO, n_stages=PP_STAGES,
            double_buffer=double))
        err = _hold_replay(torch, label, (out,), (want_out,))
        rels = _grad_rels(torch, got, want)
        worst = max(rels, key=rels.get)
        if not all(map(math.isfinite, rels.values())) or \
                rels[worst] > TRAIN_GRAD_REL_TOL:
            fail(f"{label}: grad rel {rels}")
        outs[double] = out
        print(f"{label}-buffered: {PP_MODEL} {cfg.n_layers} layers in "
              f"{PP_STAGES} stages, {PP_MICRO} microbatches of 1 x {PP_SEQ}; "
              f"out max abs err {err:.3e}; grad rel over {len(rels)} leaves "
              f"worst {worst}={rels[worst]:.3e}; fwd+bwd_s="
              f"{time.perf_counter() - t0:.2f}", flush=True)
        del got
    if not torch.equal(outs[False], outs[True]):
        fail("18c. pp replay: the two schedules' outputs differ")
    print("18c. pp replay: single- and double-buffered outputs equal bit "
          "for bit", flush=True)
    del params, layers, x, want, outs
    torch.cuda.empty_cache()
    print(f"18c: {time.perf_counter() - t_phase:.1f}s", flush=True)


def entry_point(torch, flash, paged):
    """Phase 18d: ENTRY_SPEC (its mesh {dp: 1, tp: 1, pp: 1, ep: 1}: the
    new axes, one device each; ``pipeline_stages: 1``; llama3_1b at full
    width and depth on one 4,096-token row, flash, remat dots) compiled
    by the port with the gpu preset and run for ENTRY_STEPS steps by the
    port's launcher with a one-process bootstrap env: a real one-rank
    NCCL group, which runs no collective here. Finite losses, every
    flash kernel launched, no process group left behind. Returns the
    launches."""
    import shutil
    import tempfile

    from polyaxon_tpu_torch.parallel import bootstrap

    label = "18d. entry point"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-entry-")
    spec = os.path.join(tmp, "model_parallel.yaml")
    with open(spec, "w") as fh:
        fh.write(ENTRY_SPEC)
    job = compile_example(spec, label)
    if job["mesh"]["axes"] != {"dp": 1, "tp": 1, "pp": 1, "ep": 1}:
        fail(f"{label}: the compiled mesh is {job['mesh']}")
    env = {bootstrap.ENV_NUM_PROCESSES: "1", bootstrap.ENV_PROCESS_ID: "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        _zero(flash, paged)
        emitted, outputs, launches, wall = launch_in_process(job, tmp, label)
        counts = _counts(flash, paged)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    import torch.distributed as dist

    if dist.is_initialized():
        fail(f"{label}: the launcher left its process group behind")
    _check_emissions(label, emitted, ENTRY_STEPS)
    if counts != launches or not all(counts[k] for k in (
            "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")):
        fail(f"{label}: launches {counts} (launcher's line {launches})")
    print(f"{label}: mesh {job['mesh']['axes']}, one-rank NCCL group (no "
          f"collective runs), {ENTRY_STEPS} steps, losses "
          f"{[round(v['loss'], 5) for v in emitted]}, tokens_per_s="
          f"{outputs['throughput']:.1f}, launches {counts}, wall_s="
          f"{wall:.1f} phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return counts


def model_parallel(torch, llama, flash, paged):
    """Phase 18; returns 18d's launches."""
    t0 = time.perf_counter()
    tp_replay(torch, llama, flash)
    ep_replay(torch, flash)
    pp_replay(torch, llama, flash)
    counts = entry_point(torch, flash, paged)
    print(f"phase 18: {time.perf_counter() - t0:.1f}s", flush=True)
    return counts


GANG_MODEL = "llama3_8b"
GANG_TP = 2
GANG_PROMPTS = 8          # the 16-request mix's first eight
GANG_NEW = 32
GANG_HELD = 9             # the prefill's token and 8 decode steps'
GANG_TIMEOUT = 600


def _gang_logits(torch, family, cfg, params, prompt, toks, device="cuda"):
    """f32 logits [len(toks), V] of a dense prefill of ``prompt`` and
    ``len(toks) - 1`` decode steps teacher-forced on ``toks``:
    ``family`` is the llama module, or a serving gang's view of it."""
    row = torch.tensor([prompt], dtype=torch.long, device=device)
    logits, cache = family.prefill(cfg, params, row,
                                   len(prompt) + len(toks))
    out = [logits[0]]
    for t, tok in enumerate(toks[:-1]):
        step, cache = family.decode_step(
            cfg, params, cache,
            torch.tensor([tok], dtype=torch.long, device=device),
            len(prompt) + t)
        out.append(step[0])
    return torch.stack(out).float()


def serve_rank(rank: int, port: int, workdir: str) -> None:
    """One rank of a serving gang sharing the card with the other over a
    gloo group (``scripts/probe_gloo_cuda.py``: gloo carries the gang's
    collectives of CUDA tensors; NCCL refuses two ranks on one device):
    a ``ServingServer`` over the job's mesh (phase 19: llama3_8b at
    ``{"tp": 2}``; phase 21b: moe_8x200m at ``{"ep": 2}`` with its
    ``capacity_factor``) whose rank 0 runs the paged engine on the job's
    prompts and writes what it served to ``workdir``: for phase 19 the
    teacher-forced logits through the gang too, for an MoE each row's
    recorded routing (``_EngineRoutes``)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from polyaxon_tpu_torch.models import family_of
    from polyaxon_tpu_torch.ops import flash, paged_attention
    from polyaxon_tpu_torch.serving.gang import ParamsRef
    from polyaxon_tpu_torch.serving.quantize import tree_bytes
    from polyaxon_tpu_torch.serving.server import ServingServer

    with open(os.path.join(workdir, "job.json")) as fh:
        job = json.load(fh)
    model = job.get("model", GANG_MODEL)
    axes = job.get("axes", {"tp": GANG_TP})
    family = family_of(model)
    if "capacity_factor" in job:
        family.CONFIGS[model] = dataclasses.replace(
            family.CONFIGS[model], capacity_factor=job["capacity_factor"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=math.prod(axes.values()), rank=rank)
    t0 = time.perf_counter()
    server = ServingServer(model, seed=SEED, mesh_axes=axes,
                           batching="continuous", kv="paged", slots=8,
                           device="cuda")
    load_s = time.perf_counter() - t0
    params = server.gang.worker.roles["target"][2]
    out = {"rank": rank, "load_s": load_s,
           "param_gb": tree_bytes(params) / 1e9}
    try:
        if not server.is_leader:
            server.follow()
        else:
            server.start()  # stop() below shuts down its HTTP loop
            cfg = server.gang.worker.roles["target"][1]
            routing = None
            if "want" not in job:  # an MoE: record each row's routing
                routing = _Routing(torch, family).__enter__()
                routes = _EngineRoutes(torch, server.engine, routing,
                                       cfg.n_layers)
            _zero(flash, paged_attention)
            t1 = time.perf_counter()
            reqs = [server.engine.submit(p, GANG_NEW) for p in job["prompts"]]
            outs = [r.wait(timeout=GANG_TIMEOUT) for r in reqs]
            wall = time.perf_counter() - t1
            out["counts"] = _counts(flash, paged_attention)
            stats = server.engine.stats()
            out.update(outs=outs, wall_s=wall,
                       decode_step_ms_median=stats["decode_step_ms_median"],
                       decode_steps=stats["decode_steps"])
            if routing is not None:
                routing.__exit__()
                routes.finish()
                out["routes"] = [
                    routes.row(r, p + o, len(p) + len(o) - 1).tolist()
                    for r, p, o in zip(reqs, job["prompts"], outs)]
            else:
                fam = server.gang.family("target", family)
                logits = [_gang_logits(torch, fam, cfg, ParamsRef("target"),
                                       p, w)
                          for p, w in zip(job["prompts"], job["want"])]
                np.save(os.path.join(workdir, "logits.npy"),
                        torch.stack(logits).cpu().numpy())
            server.stop()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["calls"] = server.gang.calls
    finally:
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()


def sharded_serving(torch, llama, flash, paged):
    """Phase 19a: llama3_8b at full width and depth (random bf16 weights
    from SEED) served at tp2 through the gang engine, two processes
    sharing the card over gloo, on the paged continuous engine and the
    16-request mix's first eight prompts, held against the unsharded
    paged engine on the same weights: the prefill's and the first 8
    decode steps' logits (teacher-forced on the unsharded tokens) within
    MODEL_REL_TOL, and over those steps the greedy tokens equal up to a
    row's first divergence, which must sit where the unsharded top-2
    margin is a near-tie (phase 2's rule). Returns rank 0's kernel
    launches."""
    import tempfile

    import numpy as np

    from polyaxon_tpu_torch.parallel.bootstrap import free_port
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import load_params

    t_phase = time.perf_counter()
    cfg, params = load_params(GANG_MODEL, seed=SEED, device="cuda")
    prompts = make_prompts(cfg.vocab_size)[:GANG_PROMPTS]
    eng = ContinuousBatchingEngine(GANG_MODEL, cfg, params, slots=8,
                                   kv="paged", page_size=16, device="cuda")
    try:
        _, want, wall = _run_engine_mix(eng, prompts, GANG_NEW)
    finally:
        eng.stop()
    ref = torch.stack([_gang_logits(torch, llama, cfg, params, p,
                                    w[:GANG_HELD])
                       for p, w in zip(prompts, want)])
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) >= _tie_tol(torch, ref)).cpu()
    ref = ref.cpu()
    del params, eng, top2
    torch.cuda.empty_cache()
    print(f"19a. unsharded paged engine: {len(prompts)} prompts x "
          f"{GANG_NEW} tokens in {wall:.2f}s "
          f"({len(prompts) * GANG_NEW / wall:.1f} tokens/s); of its "
          f"{clear.numel()} held steps {int((~clear).sum())} are near-ties",
          flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        with open(os.path.join(workdir, "job.json"), "w") as fh:
            json.dump({"prompts": prompts,
                       "want": [w[:GANG_HELD] for w in want]}, fh)
        port = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--serve-rank", str(r), str(port),
                                   workdir]) for r in range(GANG_TP)]
        try:
            codes = [p.wait(timeout=GANG_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            fail(f"19a: the tp{GANG_TP} gang's ranks exited with {codes}")
        ranks = []
        for r in range(GANG_TP):
            with open(os.path.join(workdir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        got = torch.from_numpy(np.load(os.path.join(workdir, "logits.npy")))
    lead = ranks[0]
    if not torch.isfinite(got).all() or got.shape != ref.shape:
        fail(f"19a: gang logits {tuple(got.shape)} non-finite or not "
             f"{tuple(ref.shape)}")
    worst = max(_rel(got[i], ref[i]) for i in range(len(prompts)))
    if worst > MODEL_REL_TOL:
        fail(f"19a: tp{GANG_TP} logits vs unsharded relative max err "
             f"{worst} (tol {MODEL_REL_TOL})")
    _check_outs("19a gang", prompts, lead["outs"], GANG_NEW, cfg.vocab_size)
    parted = {}
    for i in range(len(prompts)):
        j = next((t for t, (a, b) in enumerate(zip(
            lead["outs"][i][:GANG_HELD], want[i])) if a != b), None)
        if j is None:
            continue
        if bool(clear[i, j]):
            fail(f"19a: row {i} parts from the unsharded tokens at token "
                 f"{j}, where the unsharded top-2 margin is no near-tie")
        parted[i] = j
    if len({r["calls"] for r in ranks}) != 1:
        fail(f"19a: the ranks ran different model calls: "
             f"{[r['calls'] for r in ranks]}")
    counts = lead["counts"]
    for name in SERVING_KERNELS:
        if counts[name] <= 0:
            fail(f"19a: the gang never launched the {name} kernel")
    tokens = sum(len(o) for o in lead["outs"])
    print(f"19a. {GANG_MODEL} tp{GANG_TP} gang (two processes on one card, "
          f"gloo): {len(prompts)} prompts x {GANG_NEW} tokens, "
          f"tokens_per_s={tokens / lead['wall_s']:.1f} "
          f"decode_step_ms_median={lead['decode_step_ms_median']:.3f} "
          f"decode_steps={lead['decode_steps']} model_calls={lead['calls']} "
          f"load_s={[round(r['load_s'], 1) for r in ranks]} "
          f"peak_gb_per_rank={[round(r['peak_gb'], 2) for r in ranks]}; "
          f"logits rel err {worst:.3e} over the prefill and {GANG_HELD - 1} "
          f"decode steps; rows parted at a near-tie (row: token) {parted}; "
          f"launches "
          f"rank 0 {counts}", flush=True)
    print(f"phase 19: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return counts  # rank 0's (rank 1 runs the same calls on its heads)


# Phase 20: an elastic gang on the one card. llama3_1b at full width, cut
# to ELASTIC_LAYERS of its 16 layers (the gloo all-reduce of the f32
# gradients dominates a step, and the vocabulary's two 263 M-parameter
# matrices dominate those), dp2 as two ranks sharing the card over gloo,
# adafactor (its factored moments keep a checkpoint at the parameters'
# 2.6 GB), checkpoints every 2 steps; chaos slice loss after the first
# checkpoint, capacity back after the third, so the shrunk segment trains
# timed steps too.
ELASTIC_LAYERS = 2
ELASTIC_STEPS = 8
ELASTIC_SPEC = {
    "kind": "operation",
    "termination": {"maxRetries": 1},
    "component": {"name": "chip-smoke-elastic", "run": {
        "kind": "jaxjob", "numProcesses": 1,
        "mesh": {"axes": {"dp": 2}},
        "checkpointing": {"enabled": True, "intervalSteps": 2,
                          "maxToKeep": 3, "asyncSave": False,
                          "restoreOnStart": True},
        "runtime": {
            "model": "llama3_1b", "n_layers": ELASTIC_LAYERS,
            "dataset": "lm_packed_synthetic", "steps": ELASTIC_STEPS,
            "seq_len": 4096, "global_batch_size": 4,
            "learning_rate": 3e-4, "optimizer": "adafactor",
            "remat": "dots",
            "attention_impl": "flash", "log_every": 1, "seed": SEED,
        },
    }},
}
ELASTIC_TIMEOUT = 600
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")


def train_rank() -> None:
    """One rank of phase 20's local gangs: two ranks share the card, so
    the rank starts a gloo group from the gang's env contract (NCCL
    refuses two ranks on one device; gloo carries the collectives of
    CUDA tensors, ``scripts/probe_gloo_cuda.py``) and then runs the
    launcher, which keeps that group."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from polyaxon_tpu_torch.parallel import bootstrap
    from polyaxon_tpu_torch.runtime import launch

    group = bootstrap.read_env_contract()
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{group.coordinator}",
        world_size=group.num_processes, rank=group.process_id)
    sys.exit(launch.main())


def _rank_launches(log_dir: str) -> dict:
    """Every ``launches`` line the gangs' ranks printed, summed."""
    total = dict.fromkeys(("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                           "paged_decode"), 0)
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("rank-"):
            for rec in _json_lines(os.path.join(log_dir, name)):
                for k, v in rec.get("launches", {}).items():
                    total[k] += v
    return total


def _segments(trace: list) -> list:
    """Per segment (its ``runtime`` span, in time order): the mean step
    ms of its timed steps and its restore span."""
    spans = [r for r in trace if r.get("type") == "span"
             and r.get("end") is not None]
    out = []
    for run in sorted((r for r in spans if r["name"] == "runtime"),
                      key=lambda r: r["start"]):
        mine = [r for r in spans if r.get("parent_id") == run["span_id"]]
        steps = [r["attributes"] for r in mine if r["name"] == "step"
                 and r["attributes"].get("steps")]
        n = sum(a["steps"] for a in steps)
        out.append({
            "run": run,
            "devices": run["attributes"].get("devices"),
            "steps": n,
            "step_ms": (sum(a["step_time_ms"] * a["steps"] for a in steps)
                        / n if n else None),
            "restore": next((r for r in mine if r["name"] == "restore"),
                            None),
            "saves": [r for r in mine if r["name"] == "checkpoint"],
        })
    return out


def elastic_gang(torch, flash, paged):
    """Phase 20: ``ELASTIC_SPEC`` submitted to the port's plane and run by
    its in-process agent over two local devices that share the card
    (``Agent(local_devices=[0, 0])``, each rank ``train_rank``), first
    unresized with checkpointing off, then with chaos slice loss, so it
    trains dp2 → dp1 → dp2: two ranks, then one in the agent's thread,
    then two. Prints each segment's step ms, each resize's seconds
    (prewarm, the forced save, the relaunch up to the restore, the
    restore), the restore tiers, ``meta["elastic"]`` and each step's
    loss against the unresized run's (TRAIN_LOSS_REL_TOL relative).
    Returns the elastic run's launches, its ranks' and its thread's."""
    import copy
    import shutil
    import tempfile

    from polyaxon_tpu_torch import chaos
    from polyaxon_tpu_torch.agent import Agent
    from polyaxon_tpu_torch.controlplane import ControlPlane
    from polyaxon_tpu_torch.lifecycle import V1Statuses
    from polyaxon_tpu_torch.obs.trace import read_trace
    from polyaxon_tpu_torch.runtime import elastic, tiers

    label = "20. elastic"
    t_phase = time.perf_counter()
    rank_cmd = [sys.executable, os.path.abspath(__file__), "--train-rank"]
    tmp = tempfile.mkdtemp(prefix="chip-smoke-elastic-")
    prewarm_env = os.environ.get(elastic.ENV_ELASTIC_PREWARM)
    # The structural prewarm: the default one-step child is driven on
    # four cards (scripts/parallel_gpus.py --gangs elastic).
    os.environ[elastic.ENV_ELASTIC_PREWARM] = "inline"
    try:
        plane = ControlPlane(os.path.join(tmp, "home"))
        agent = Agent(plane, in_process=True, local_devices=[0, 0])

        def run(spec, what):
            record = plane.submit(spec)
            plane.compile_run(record.uuid)
            plan = plane.get_run(record.uuid).launch_plan
            proc = plan["processes"][0]
            if list(proc["command"]) + list(proc["args"]) != LAUNCHER:
                fail(f"{label}: the plan runs {proc['command']}")
            proc["command"], proc["args"] = rank_cmd, []
            plane.store.update_run(record.uuid, launch_plan=plan)
            t0 = time.perf_counter()
            status = agent.run_until_done(record.uuid,
                                          timeout=ELASTIC_TIMEOUT)
            wall = time.perf_counter() - t0
            art = plane.run_artifacts_dir(record.uuid)
            if status != V1Statuses.SUCCEEDED:
                tails = "".join(_tail(os.path.join(art, "logs", n), 3000)
                                for n in sorted(os.listdir(
                                    os.path.join(art, "logs"))))
                fail(f"{label}: the {what} run ended {status.value}: "
                     f"{plane.get_statuses(record.uuid)[-1]}\n{tails}")
            losses = {e["step"]: e["value"] for e in plane.streams.get_metrics(
                record.uuid, ["loss"])["loss"]}
            return record, art, losses, wall

        ref_spec = copy.deepcopy(ELASTIC_SPEC)
        ref_spec["component"]["run"]["checkpointing"] = {"enabled": False}
        _, _, want, ref_wall = run(ref_spec, "unresized")
        if sorted(want) != list(range(1, ELASTIC_STEPS)):
            fail(f"{label}: the unresized run emitted steps {sorted(want)}")

        _zero(flash, paged)
        chaos.install(chaos.ChaosPlan.from_dict({"seed": SEED, "faults": [
            {"seam": "slice-loss", "op": "kill",
             "config": {"min_checkpoints": 1}},
            {"seam": "slice-loss", "op": "restore",
             "config": {"min_checkpoints": 3}}]}))
        try:
            record, art, got, wall = run(ELASTIC_SPEC, "elastic")
            fired = chaos.active_plan().consumed
        finally:
            chaos.uninstall()
        threaded = _counts(flash, paged)
        record = plane.get_run(record.uuid)
        audit = record.meta.get("elastic") or {}
        attempts = [(a["direction"], a["outcome"], a["from_devices"],
                     a["to_devices"]) for a in audit.get("attempts", [])]
        if attempts != [("shrink", "ok", 2, 1), ("grow", "ok", 1, 2)] \
                or record.retries or len(fired) != 2:
            fail(f"{label}: resizes {audit}, retries {record.retries}, "
                 f"faults fired {fired}")
        outputs = plane.streams.get_outputs(record.uuid)
        if outputs["steps"] != ELASTIC_STEPS:
            fail(f"{label}: {outputs['steps']} steps, want {ELASTIC_STEPS}")
        verdicts = {v["invariant"]: v["verdict"]
                    for v in plane.verify(record.uuid)["verdicts"]}
        if verdicts["loss-continuity"] != "pass":
            fail(f"{label}: loss-continuity {verdicts['loss-continuity']}")
        if len(got) < 3 or not set(got) <= set(want):
            fail(f"{label}: emitted steps {sorted(got)}")
        worst = 0.0
        for step in sorted(got):
            rel = abs(got[step] - want[step]) / abs(want[step])
            worst = max(worst, rel)
            if not math.isfinite(got[step]) or rel > TRAIN_LOSS_REL_TOL:
                fail(f"{label}: step {step} loss {got[step]} against the "
                     f"unresized {want[step]} (relative {rel:.2e}, tol "
                     f"{TRAIN_LOSS_REL_TOL})")
            print(f"{label} step {step}: loss={got[step]:.6f} unresized="
                  f"{want[step]:.6f} rel={rel:.2e}", flush=True)

        trace = read_trace(art)
        segments = _segments(trace)
        resizes = sorted((r for r in trace if r.get("name") == "resize"
                          and r.get("end") is not None),
                         key=lambda r: r["start"])
        if [s["devices"] for s in segments] != [2, 1, 2] \
                or len(resizes) != 2:
            fail(f"{label}: segments over {[s['devices'] for s in segments]}"
                 f" devices, {len(resizes)} resize spans")
        for i, seg in enumerate(segments):
            restore = seg["restore"]
            step_ms = seg["step_ms"] and round(seg["step_ms"], 1)
            print(f"{label} segment {i}: {seg['devices']} rank(s), "
                  f"{seg['steps']} timed steps, step_ms={step_ms}, restore="
                  + (f"{restore['duration_ms'] / 1e3:.2f}s tier "
                     f"{restore['attributes'].get('restore_tier')} from step "
                     f"{restore['attributes'].get('restored_from_step')}"
                     if restore else "none"), flush=True)
        for i, rz in enumerate(resizes):
            before, after = segments[i], segments[i + 1]
            final = [c for c in before["saves"]
                     if c["attributes"].get("final")]
            if not final or after["restore"] is None:
                fail(f"{label}: resize {i} lacks its forced save or restore")
            save_s = final[-1]["duration_ms"] / 1e3
            prewarm_s = rz["duration_ms"] / 1e3
            relaunch_s = after["restore"]["start"] - rz["end"]
            restore_s = after["restore"]["duration_ms"] / 1e3
            print(f"{label} resize {i} ({rz['attributes']['direction']} "
                  f"{rz['attributes']['from_devices']}→"
                  f"{rz['attributes']['to_devices']} at step "
                  f"{rz['attributes']['from_step']}): forced_save_s="
                  f"{save_s:.2f} prewarm_s={prewarm_s:.2f} (inline, with "
                  f"the tier-0 warm) relaunch_s={relaunch_s:.2f} (to the "
                  f"restore's start) restore_s={restore_s:.2f} tier "
                  f"{after['restore']['attributes'].get('restore_tier')}; "
                  f"sum {save_s + prewarm_s + relaunch_s + restore_s:.2f}s",
                  flush=True)
        stops = [r["outputs"]["stop_check_ms"] for r in _json_lines(
            os.path.join(art, "logs", "rank-0.log")) if "outputs" in r]
        launches = _rank_launches(os.path.join(art, "logs"))
        counts = {k: launches[k] + threaded[k] for k in launches}
        for name in TRAINING_KERNELS:
            if threaded[name] <= 0 or launches[name] <= 0:
                fail(f"{label}: {name} launched {threaded[name]} times in "
                     f"the thread's segment, {launches[name]} in the ranks'")
        print(f"{label}: meta[\"elastic\"]={json.dumps(audit)}", flush=True)
        print(f"{label}: meta[\"checkpoint\"]="
              f"{json.dumps(record.meta.get('checkpoint'))}; the gangs' "
              f"stop agreement (one gloo all-reduce a step) "
              f"stop_check_ms={[round(x, 3) for x in stops]}; elastic "
              f"wall_s={wall:.1f} unresized wall_s={ref_wall:.1f}; loss "
              f"worst rel {worst:.2e}; launches ranks {launches} thread "
              f"{threaded}", flush=True)
    finally:
        if prewarm_env is None:
            os.environ.pop(elastic.ENV_ELASTIC_PREWARM, None)
        else:
            os.environ[elastic.ENV_ELASTIC_PREWARM] = prewarm_env
        tiers.TIER0.clear()
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 20: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return counts


# Phase 21: the axis pairs. (a) The new pairs' rank programs replayed
# in this process at full width (depth cut to PAIR_LAYERS of llama3_8b's
# 32 layers to keep the phase near 150 s; moe_8x200m at its full 12);
# (b) moe_8x200m served at ep2 by two processes sharing the card over
# gloo.
PAIR_MODEL = "llama3_8b"
PAIR_LAYERS = 8
PAIR_SEQ = 4096
PAIR_ROWS = 2          # pp2 x tp2: two microbatches of one row
PAIR_TP, PAIR_PP, PAIR_CP, PAIR_EP = 2, 2, 2, 2
EP_GANG_MODEL = "moe_8x200m"
EP_GANG = 2


def _vocab_replay(torch, llama, tensor, cfg, params, inputs, n):
    """Each tp rank's vocab-parallel embedding rows of ``inputs``, summed
    as the all-reduce sums them."""
    rows = cfg.vocab_size // n
    return tensor.replay_tp(
        lambda table: llama._embed(cfg, {"embed": table}, inputs,
                                   cfg.dtype), n,
        lambda j: (params["embed"][j * rows:(j + 1) * rows],))


def _vocab_ce_replay(torch, tensor, cfg, params, x, tokens, n):
    """The vocab-parallel cross entropy of every tp rank's head columns:
    the mean loss."""
    rows = cfg.vocab_size // n
    head = params["lm_head"]
    nll, _ = tensor.replay_vocab_ce(
        [(x @ head[:, j * rows:(j + 1) * rows]).float() for j in range(n)],
        tokens)
    return nll.mean()


def pair_replays(torch, llama, flash, paged):
    """Phase 21a: the rank programs of the new pairs, every rank's in this
    process, forward and backward through the flash kernels, each held
    against the unsplit step (phase 18's tolerances): llama3_8b (random
    bf16 weights from SEED, full width, PAIR_LAYERS layers) at pp2 x tp2
    (a 2-stage GPipe schedule of 2 one-row microbatches,
    ``replay_pipeline``, whose stages run each tp rank's column- and
    row-parallel blocks, ``replay_tp``) and at tp2 x cp2 on one row (each
    tp rank's heads through the zigzag ring of two cp ranks,
    ``replay_zigzag``), both with the vocab-parallel embedding and cross
    entropy; moe_8x200m (full width and depth, bf16) at tp2 x ep2 on its
    training microbatch: each tp rank's attention heads, and the ragged
    dispatch at ep2 (``replay_ep``) through each tp rank's share of every
    expert's ``mlp``, at no-drop capacity, the routing replayed from the
    unsplit run (``_Routing``). Returns the launches of the split runs."""
    from polyaxon_tpu_torch.models import moe
    from polyaxon_tpu_torch.models.common import rms_norm, shift_right, unstack
    from polyaxon_tpu_torch.ops import ring
    from polyaxon_tpu_torch.parallel import tensor
    from polyaxon_tpu_torch.parallel.pipeline import (replay_pipeline,
                                                      stack_stages)
    from polyaxon_tpu_torch.runtime.data import lm_synthetic

    t_phase = time.perf_counter()
    runs = []
    cfg = dataclasses.replace(llama.CONFIGS[PAIR_MODEL], n_layers=PAIR_LAYERS,
                              attention_impl="flash")
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda", param_dtype=torch.bfloat16)["params"]
    for t in _leaves(params):
        t.requires_grad_(True)
    tokens = torch.from_numpy(next(lm_synthetic(
        PAIR_ROWS, seq_len=PAIR_SEQ, vocab_size=cfg.vocab_size,
        seed=SEED + 7))["tokens"]).cuda().long()

    def grads_of(loss):
        loss.backward()
        out = {}
        for path, t in _named_leaves(params):
            out[path] = t.grad
            t.grad = None
        torch.cuda.synchronize()
        return loss.item(), out

    n = PAIR_TP

    def tp_layer(attn_out):
        """One layer as every tp rank computes it: ``attn_out(x, shard,
        positions)`` and the MLP partials, summed."""
        def body(x, layer, positions, _segments=None):
            x = x + tensor.replay_tp(
                attn_out, n,
                lambda j: (x, _tp_shard(cfg, layer, n, j), positions),
                remat=True)
            return x + tensor.replay_tp(
                functools.partial(llama._mlp_out, cfg), n,
                lambda j: (x, _tp_shard(cfg, layer, n, j)), remat=True)
        return body

    def ring_attn_out(x, layer, positions):
        B, S, _ = x.shape
        q, k, v = llama._qkv(cfg, layer, x, positions)
        o = ring.replay_zigzag(q, k, v, PAIR_CP)
        return o.reshape(B, S, -1) @ layer["wo"].to(cfg.dtype)

    cases = {
        f"pp{PAIR_PP} x tp{n}": (tokens, lambda x: replay_pipeline(
            llama.stage_fn(tp_layer(functools.partial(llama._attn_out,
                                                       cfg))),
            stack_stages(params["layers"], PAIR_PP), x,
            n_microbatches=PAIR_ROWS, n_stages=PAIR_PP)),
        f"tp{n} x cp{PAIR_CP}": (tokens[:1], lambda x: llama.stage_fn(
            tp_layer(ring_attn_out))(params["layers"], x)),
    }
    for label, (toks, layers) in cases.items():
        t0 = time.perf_counter()
        want_loss, want = grads_of(llama.apply(
            cfg, {"params": params, "state": {}}, {"tokens": toks})[0])
        want = {k: g.to("cpu") for k, g in want.items()}
        _zero(flash, paged)
        x = _vocab_replay(torch, llama, tensor, cfg, params,
                          shift_right(toks), n)
        x = llama._norm(cfg, layers(x), params["final_norm"])
        loss, got = grads_of(_vocab_ce_replay(torch, tensor, cfg, params, x,
                                              toks, n))
        counts = _counts(flash, paged)
        runs.append(counts)
        if not all(counts[k] for k in TRAINING_KERNELS):
            fail(f"21a. {label}: launches {counts}")
        held = _hold_training(f"21a. {label}", loss, want_loss,
                              _grad_rels(torch, got, want))
        print(f"21a. {label} replay: {PAIR_MODEL} at full width, "
              f"{PAIR_LAYERS} of {llama.CONFIGS[PAIR_MODEL].n_layers} layers, "
              f"{toks.shape[0]} x {PAIR_SEQ} "
              f"tokens, {cfg.n_heads // n}:{cfg.n_kv_heads // n} heads per tp "
              f"rank, D={cfg.head_dim}; loss {loss:.6f} vs unsplit "
              f"{want_loss:.6f}; {held}; launches {counts}; fwd+bwd_s="
              f"{time.perf_counter() - t0:.2f}", flush=True)
        del got, want, x
    del params
    torch.cuda.empty_cache()

    # moe_8x200m at tp2 x ep2.
    t0 = time.perf_counter()
    base = moe.CONFIGS["moe_8x200m"]
    mcfg = dataclasses.replace(base, attention_impl="flash",
                               capacity_factor=8.0)
    mparams = moe.init(mcfg, torch.Generator(device="cuda").manual_seed(SEED),
                       device="cuda", param_dtype=torch.bfloat16)["params"]
    layers = mparams["layers"]
    for t in _leaves(layers):
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    x0 = torch.randn(EP_BATCH, EP_SEQ, mcfg.dim, generator=gen,
                     device="cuda", dtype=torch.bfloat16).requires_grad_(True)
    do = torch.randn(x0.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    positions = llama._positions(EP_BATCH, EP_SEQ, "cuda")
    leaves = [x0, *(t for _, t in _named_leaves(layers))]
    names = ["x", *(p for p, _ in _named_leaves(layers))]

    def run(stack):
        out = stack()
        grads = torch.autograd.grad((out.float() * do.float()).sum(),
                                    leaves)
        torch.cuda.synchronize()
        return out.detach(), dict(zip(names, grads))

    def unsplit():
        x = x0
        for layer in unstack(layers):
            x = moe._layer(mcfg, x, layer, positions)[0]
        return x

    def mlp_share(key, w, j):  # tp rank j's share of each expert's mlp
        f = mcfg.ffn_dim // n
        return (w[:, j * f:(j + 1) * f] if key == "w_down"
                else w[..., j * f:(j + 1) * f])

    def split():
        x = x0
        T = EP_BATCH * EP_SEQ
        for layer in unstack(layers):
            x = x + tensor.replay_tp(
                functools.partial(llama._attn_out, mcfg), n,
                lambda j: (x, _tp_shard(mcfg, layer, n, j), positions),
                remat=True)
            h = rms_norm(x, layer["moe_norm"], mcfg.norm_eps).reshape(T, -1)
            out = tensor.replay_tp(
                lambda wg, wu, wd: moe.replay_ep(mcfg, h, layer["router"],
                                                 wg, wu, wd, PAIR_EP)[0],
                n, lambda j: tuple(mlp_share(k, layer[k], j)
                                   for k in ("w_gate", "w_up", "w_down")))
            x = x + out.reshape(x.shape)
        return x

    with _Routing(torch, moe) as rec:
        want_out, want = run(unsplit)
    # Per layer, each tp rank routes each ep rank's token chunk.
    chunk = EP_BATCH * EP_SEQ // PAIR_EP
    replay = [call[i * chunk:(i + 1) * chunk] for call in rec.calls
              for _ in range(n) for i in range(PAIR_EP)]
    _zero(flash, paged)
    with _Routing(torch, moe, replay=replay) as routed:
        out, got = run(split)
    counts = _counts(flash, paged)
    runs.append(counts)
    label = f"21a. moe tp{n} x ep{PAIR_EP}"
    if not all(counts[k] for k in TRAINING_KERNELS):
        fail(f"{label}: launches {counts}")
    err = _rel(out, want_out)
    rels = _grad_rels(torch, got, want)
    worst = max(rels, key=rels.get)
    if err > MODEL_REL_TOL or not all(map(math.isfinite, rels.values())) \
            or rels[worst] > TRAIN_GRAD_REL_TOL:
        fail(f"{label}: out rel {err}, grad rel {rels}")
    print(f"{label} replay: moe_8x200m at full width and depth "
          f"({mcfg.n_layers} layers), {EP_BATCH} x {EP_SEQ} tokens, "
          f"{mcfg.n_experts // PAIR_EP} experts per ep rank, "
          f"{mcfg.ffn_dim // n} of each expert's {mcfg.ffn_dim} mlp columns "
          f"per tp rank, {mcfg.n_heads // n}:{mcfg.n_kv_heads // n} heads; "
          f"capacity 8.0; out rel err {err:.3e}; grad rel over {len(rels)} "
          f"leaves worst {worst}={rels[worst]:.3e}; routing flips replayed "
          f"{sum(routed.flips)}; launches {counts}; fwd+bwd_s="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    del mparams, layers, x0, want, got
    torch.cuda.empty_cache()
    print(f"21a: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return runs


class _SavedRoutes:
    """A gang rank's recorded rows (``_EngineRoutes.row`` per request
    index), read back in this process for ``moe_rows_check``."""

    def __init__(self, torch, rows: list):
        self.rows = [torch.tensor(r) for r in rows]

    def row(self, req, seq, n: int):
        return self.rows[req][:n]


def ep_serving(torch, llama, flash, paged):
    """Phase 21b: moe_8x200m (random bf16 weights from SEED, no-drop
    capacity) served at ep2 through the gang engine, two processes
    sharing the card over gloo (all-reduce, broadcast and all-gather,
    ``scripts/probe_gloo_cuda.py``): each rank holds its 4 of the 8
    experts; a decode step's MoE blocks take the dense dispatch, each
    rank running its experts and the ep group summing their parts; the
    prompt pass the ragged dispatch of the whole batch, each rank its
    experts' pairs. The paged continuous engine on the mix's first eight
    prompts, each engine's routing recorded (``_Routing``,
    ``_EngineRoutes``): every token of both engines' rows is the target's
    greedy choice given its own prefix with that engine's routing
    replayed, up to a near-tie, and a row that parts from the unsharded
    engine's does so where the routings differ or at a near-tie
    (``moe_rows_check``, phase 12's rule). Returns rank 0's launches."""
    import tempfile

    from polyaxon_tpu_torch.models import moe
    from polyaxon_tpu_torch.parallel.bootstrap import free_port
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import load_params

    label = "21b. moe ep serving"
    t_phase = time.perf_counter()
    base = moe.CONFIGS[EP_GANG_MODEL]
    no_drop = base.n_experts / base.experts_per_token
    saved = moe.CONFIGS[EP_GANG_MODEL]
    moe.CONFIGS[EP_GANG_MODEL] = dataclasses.replace(
        base, capacity_factor=no_drop)
    try:
        cfg, params = load_params(EP_GANG_MODEL, seed=SEED, device="cuda")
    finally:
        moe.CONFIGS[EP_GANG_MODEL] = saved
    prompts = [p[:cfg.max_seq_len - GANG_NEW]
               for p in make_prompts(cfg.vocab_size)[:GANG_PROMPTS]]
    eng = ContinuousBatchingEngine(EP_GANG_MODEL, cfg, params, slots=8,
                                   kv="paged", page_size=16, device="cuda")
    with _Routing(torch, moe) as routing:
        routes = _EngineRoutes(torch, eng, routing, cfg.n_layers)
        try:
            reqs, want, wall = _run_engine_mix(eng, prompts, GANG_NEW)
        finally:
            eng.stop()
    routes.finish()
    print(f"{label}: unsharded paged engine {len(prompts)} prompts x "
          f"{GANG_NEW} tokens in {wall:.2f}s", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        with open(os.path.join(workdir, "job.json"), "w") as fh:
            json.dump({"prompts": prompts, "model": EP_GANG_MODEL,
                       "family": "moe", "axes": {"ep": EP_GANG},
                       "capacity_factor": no_drop}, fh)
        port = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--serve-rank", str(r), str(port),
                                   workdir]) for r in range(EP_GANG)]
        try:
            codes = [p.wait(timeout=GANG_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            fail(f"{label}: the ep{EP_GANG} gang's ranks exited with "
                 f"{codes}")
        ranks = []
        for r in range(EP_GANG):
            with open(os.path.join(workdir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    lead = ranks[0]
    _check_outs(label, prompts, lead["outs"], GANG_NEW, cfg.vocab_size)
    if len({r["calls"] for r in ranks}) != 1:
        fail(f"{label}: the ranks ran different model calls: "
             f"{[r['calls'] for r in ranks]}")
    counts = lead["counts"]
    for name in SERVING_KERNELS:
        if counts[name] <= 0:
            fail(f"{label}: the gang never launched the {name} kernel")
    gang_routes = _SavedRoutes(torch, lead["routes"])
    parted, differ = moe_rows_check(
        torch, moe, cfg, params, label, prompts,
        {"unsharded": (reqs, want),
         f"ep{EP_GANG} gang": (list(range(len(prompts))), lead["outs"])},
        {"unsharded": routes, f"ep{EP_GANG} gang": gang_routes})
    tokens = sum(len(o) for o in lead["outs"])
    print(f"{label}: {EP_GANG_MODEL} ep{EP_GANG} gang (two processes on one "
          f"card, gloo), {cfg.n_experts // EP_GANG} of {cfg.n_experts} "
          f"experts a rank: {len(prompts)} prompts x {GANG_NEW} tokens, "
          f"tokens_per_s={tokens / lead['wall_s']:.1f} "
          f"decode_step_ms_median={lead['decode_step_ms_median']:.3f} "
          f"model_calls={lead['calls']} "
          f"param_gb_per_rank={[round(r['param_gb'], 3) for r in ranks]} "
          f"peak_gb_per_rank={[round(r['peak_gb'], 2) for r in ranks]}; rows "
          f"equal to the unsharded engine's {len(prompts) - parted}/"
          f"{len(prompts)}, of the {parted} that part {differ} where the "
          f"routings differ; launches rank 0 {counts}", flush=True)
    del params
    torch.cuda.empty_cache()
    print(f"phase 21b: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return counts


def axis_pairs(torch, llama, flash, paged):
    """Phase 21; returns the launches of its runs."""
    t0 = time.perf_counter()
    runs = pair_replays(torch, llama, flash, paged)
    runs.append(ep_serving(torch, llama, flash, paged))
    print(f"phase 21: {time.perf_counter() - t0:.1f}s", flush=True)
    return runs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "polyaxon_tpu_torch")):
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, repo)
    # The agent's gangs run `python -m polyaxon_tpu_torch...` from the
    # plan's working directory; the checkout must be importable there.
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p)
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.ops import _build, flash, paged_attention
    from polyaxon_tpu_torch.serving.server import load_params

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    peaks = card_peaks(name)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    print(f"card: {smi} | peaks used: {peaks[2]} "
          f"{peaks[0] / 1e12:.0f} TFLOP/s bf16, {peaks[1] / 1e12:.2f} TB/s",
          flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc "
          f"{nvcc.strip().splitlines()[-1] if nvcc.strip() else '?'}",
          flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for kernel, log in logs.items():
        for line in log.splitlines():  # per instantiation; spills if any
            if "registers" in line or (
                    "spill" in line and " 0 bytes spill stores" not in line):
                print(f"  ptxas[{kernel}] {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    flash_rec = check_flash(torch, flash, peaks, gen)
    paged_rec = check_paged(torch, paged_attention, peaks, gen)
    check_decode_streams(torch, paged_attention, gen)
    bwd_recs = check_flash_bwd(torch, flash, peaks, gen)
    path_worst, _ = check_path_shapes(torch, flash, peaks, gen)
    flash_rec["max_abs_err"] = max(flash_rec["max_abs_err"],
                                   path_worst["fwd"])
    for kernel in ("dkdv", "dq"):
        bwd_recs[kernel]["max_abs_err"] = max(
            bwd_recs[kernel]["max_abs_err"], path_worst[kernel])
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params = load_params("llama3_8b", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"weights: llama3_8b {n_params / 1e9:.2f}B params bf16, "
          f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.1f}s, "
          f"attention_impl={cfg.attention_impl} "
          f"paged_attention_impl={cfg.paged_attention_impl}", flush=True)
    counts, prompts, paged_stats = run_engine(flash, paged_attention, cfg,
                                              params)
    compare_first_admission(torch, llama, cfg, params, prompts[0])
    time_prefill(torch, llama, flash, cfg, params)
    serve_counts = serve_the_rest(torch, llama, flash, paged_attention, cfg,
                                  params, prompts, paged_stats)
    del params
    torch.cuda.empty_cache()
    serve_counts += (mistral_ring(torch, llama, flash, paged_attention),
                     fleet(torch, flash, paged_attention))

    run_http(flash, paged_attention)

    train_counts, train_losses, train_result = run_training(
        torch, flash, paged_attention, TRAIN_JOB, TRAIN_LAYERS)
    torch.cuda.empty_cache()
    first_step_parity(torch, llama, flash)
    torch.cuda.empty_cache()
    gemma_counts = run_training(torch, flash, paged_attention, GEMMA_JOB,
                                GEMMA_LAYERS)[0]
    torch.cuda.empty_cache()

    drill_counts = checkpoint_drill(torch, flash, paged_attention, llama,
                                    train_losses, train_result)
    torch.cuda.empty_cache()
    plan_counts = compiled_launch(torch, llama, train_result)
    torch.cuda.empty_cache()
    sweep_counts = sweep(torch, flash, paged_attention)
    torch.cuda.empty_cache()
    family_counts = families(torch, llama, flash, paged_attention)
    release(torch)
    chaos_restore(torch, llama)
    ring_counts = context_parallel(torch, llama, flash, paged_attention)
    torch.cuda.empty_cache()
    entry_counts = model_parallel(torch, llama, flash, paged_attention)
    torch.cuda.empty_cache()
    gang_counts = sharded_serving(torch, llama, flash, paged_attention)
    torch.cuda.empty_cache()
    elastic_counts = elastic_gang(torch, flash, paged_attention)
    torch.cuda.empty_cache()
    pair_counts = axis_pairs(torch, llama, flash, paged_attention)

    # Each kernel's launches are the sum over the main-path runs that
    # reach it (each printed above): the engine, phases a-g, the two
    # training runs,
    # the resumed launcher of the checkpoint drill, the engine serving
    # its checkpoint, the launcher the agent ran from the compiled plan,
    # the sweep's trials and the engine serving its best trial, the runs
    # of phases 11-15, the longcontext run of phase 17, the entry
    # point's run of phase 18, rank 0 of phase 19's gang, phase 20's
    # elastic run (its gangs' ranks and its one-device segment) and phase
    # 21's split runs and rank 0 of its ep gang.
    runs = (counts, *serve_counts, train_counts, gemma_counts, *drill_counts,
            plan_counts, *sweep_counts, *family_counts, ring_counts,
            entry_counts, gang_counts, elastic_counts, *pair_counts)

    def total(name):
        return sum(run.get(name, 0) for run in runs)

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:177",
             launches=total("flash_fwd"), **_ordered(flash_rec)),
        dict(name="paged_decode", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="polyaxon_tpu/ops/paged_attention.py:39",
             launches=total("paged_decode"), **_ordered(paged_rec)),
        dict(name="flash_bwd_dkdv", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_bwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:417",
             launches=total("flash_bwd_dkdv"),
             **_ordered(bwd_recs["dkdv"])),
        dict(name="flash_bwd_dq", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_bwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:484",
             launches=total("flash_bwd_dq"), **_ordered(bwd_recs["dq"])),
    ]
    print(f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def _ordered(rec: dict) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {k: rec[k] for k in keys}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-rank"]:  # phase 19's gang ranks
        serve_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--train-rank"]:  # phase 20's gang ranks
        train_rank()
    else:
        main()
