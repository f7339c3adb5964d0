"""Compile a resolved operation into a launch plan (port of
``polyaxon_tpu/compiler/compile.py``; plans name the port's launcher).

One converter per run kind, mirroring the reference's
``converter/converters/{job,service,kubeflow}.py`` split (SURVEY.md §2
[K]) with a native jaxjob converter replacing the Kubeflow delegation:

- jaxjob → one SPMD process per slice host; env contract carries the
  ``jax.distributed`` bootstrap (coordinator/process id/count over DCN)
  and the tracking paths; resources request ``google.com/tpu`` with
  topology [B].
- tfjob/pytorchjob/mpijob → per-replica processes with the frameworks'
  rendezvous env (TF_CONFIG / MASTER_ADDR+RANK / OMPI vars) so existing
  Polyaxonfiles compile unchanged; execution of those frameworks is
  delegated, as upstream does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

from polyaxon_tpu_torch.compiler.plan import (
    COORDINATOR_PLACEHOLDER,
    COORDINATOR_PORT,
    V1InitPhase,
    V1LaunchPlan,
    V1ProcessSpec,
    V1ResourceRequest,
    V1SidecarSpec,
    builtin_runtime_command,
    sidecar_sync_command,
)
from polyaxon_tpu_torch.polyflow.component import V1Component
from polyaxon_tpu_torch.polyflow.environment import TPU_RESOURCE
from polyaxon_tpu_torch.polyflow.operation import V1Operation
from polyaxon_tpu_torch.polyflow.runs import V1JAXJob, V1RunKind
from polyaxon_tpu_torch.tracking.run import (
    ENV_ARTIFACTS_PATH,
    ENV_OUTPUTS_PATH,
    ENV_PROJECT,
    ENV_RUN_NAME,
    ENV_RUN_UUID,
)

ENV_JAXJOB_SPEC = "POLYAXON_JAXJOB_SPEC"
# The multi-process bootstrap's env contract, as data (the JAX package's
# and the port's ``parallel/bootstrap.py``).
ENV_COORDINATOR = "POLYAXON_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "POLYAXON_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "POLYAXON_TPU_PROCESS_ID"
ENV_LOCAL_DEVICE_IDS = "POLYAXON_TPU_LOCAL_DEVICE_IDS"


class CompilerError(ValueError):
    pass


def _base_env(plan_args: dict[str, Any]) -> dict[str, str]:
    env = {
        ENV_RUN_UUID: plan_args["run_uuid"],
        ENV_RUN_NAME: plan_args.get("run_name") or "",
        ENV_PROJECT: plan_args.get("project") or "",
        ENV_ARTIFACTS_PATH: plan_args["artifacts_dir"],
        ENV_OUTPUTS_PATH: plan_args["outputs_dir"],
    }
    return env


def _io_env(op: V1Operation) -> dict[str, str]:
    """Params/IO routed to env via ``toEnv`` (SURVEY §2 IO contract)."""
    env: dict[str, str] = {}
    component = op.component
    if component is None:
        return env
    params = op.params or {}
    for io in (component.inputs or []) + (component.outputs or []):
        if not io.to_env:
            continue
        param = params.get(io.name)
        value = param.value if param is not None else io.value
        if value is not None:
            env[io.to_env] = value if isinstance(value, str) else json.dumps(value)
    return env


def _container_cmd(container) -> tuple[list[str], list[str]]:
    command = container.command_list() if container else []
    args = container.args_list() if container else []
    return command, [str(a) for a in args]


def _init_phases(run, plugins, catalog=None) -> list[V1InitPhase]:
    phases: list[V1InitPhase] = []
    if plugins is None or plugins.auth is not False:
        phases.append(V1InitPhase(kind="auth", config={}))
    for init in getattr(run, "init", None) or []:
        if init.git is not None:
            config = dict(init.git)
            # Canonical upstream form: the url lives on the git
            # connection, only e.g. `revision` is inline. Resolve it at
            # compile time so the executor sees a complete phase.
            if not config.get("url") and init.connection and catalog is not None:
                try:
                    conn = catalog.get(init.connection)
                except ValueError as exc:
                    raise CompilerError(str(exc)) from exc
                url = (conn.schema_ or {}).get("url")
                if url:
                    config["url"] = url
            phases.append(V1InitPhase(kind="git", config=config,
                                      connection=init.connection, path=init.path))
        elif init.artifacts is not None:
            phases.append(V1InitPhase(kind="artifacts", config=init.artifacts,
                                      connection=init.connection, path=init.path))
        elif init.dockerfile is not None:
            phases.append(V1InitPhase(kind="dockerfile", config=init.dockerfile))
        elif init.file is not None:
            phases.append(V1InitPhase(kind="file", config=init.file, path=init.path))
        elif init.tpu_metadata:
            phases.append(V1InitPhase(kind="tpu_metadata", config={}))
        elif init.container is not None:
            phases.append(V1InitPhase(kind="container",
                                      config=init.container.to_dict()))
    return phases


def _sidecars(run, plugins, artifacts_dir: str, store_dir: Optional[str]) -> list[V1SidecarSpec]:
    sidecars: list[V1SidecarSpec] = []
    collect = plugins is None or plugins.collect_logs is not False or bool(
        plugins and plugins.collect_artifacts
    )
    if collect and store_dir:
        sidecars.append(
            V1SidecarSpec(
                kind="sync",
                command=sidecar_sync_command(artifacts_dir, store_dir),
                config={"store_dir": store_dir},
            )
        )
    for sc in getattr(run, "sidecars", None) or []:
        cmd, args = _container_cmd(sc)
        sidecars.append(V1SidecarSpec(kind="container", command=cmd + args,
                                      config=sc.to_dict()))
    return sidecars


# ---------------------------------------------------------------------------
# Converters per kind
# ---------------------------------------------------------------------------

def _compile_jaxjob(job: V1JAXJob, plan_args, env_base) -> tuple[V1ResourceRequest, list[V1ProcessSpec]]:
    topo = job.get_topology()
    n_proc = job.num_processes or topo.total_hosts()
    resources = V1ResourceRequest(
        resources={TPU_RESOURCE: topo.chips_per_slice() // max(topo.hosts_per_slice(), 1)},
        accelerator=topo.accelerator,
        topology=topo.topology,
        slices=topo.slices,
        chips=topo.total_chips(),
        hosts=n_proc,
        preemptible=bool(topo.preemptible),
        node_selector=(job.environment.node_selector if job.environment else None),
    )
    if job.runtime is not None:
        command, args = builtin_runtime_command(), []
        extra_env = {ENV_JAXJOB_SPEC: json.dumps(job.to_dict())}
    else:
        command, args = _container_cmd(job.container)
        extra_env = {}

    processes = []
    for idx in range(n_proc):
        env = dict(env_base)
        env.update(extra_env)
        env.update({
            ENV_NUM_PROCESSES: str(n_proc),
            ENV_PROCESS_ID: str(idx),
            ENV_COORDINATOR: f"{COORDINATOR_PLACEHOLDER}:{COORDINATOR_PORT}",
        })
        if job.container and job.container.env:
            env.update({e.name: str(e.value) for e in job.container.env if e.value is not None})
        processes.append(
            V1ProcessSpec(
                index=idx, host_index=idx, command=command, args=args, env=env,
                image=(job.container.image if job.container else None),
                working_dir=(job.container.working_dir if job.container else None),
            )
        )
    return resources, processes


def _kf_env(kind: str, replica: str, idx: int, global_idx: int, topology: dict) -> dict[str, str]:
    """Framework rendezvous env for delegated kinds (SURVEY §2c)."""
    if kind == V1RunKind.TFJOB:
        cluster = {
            name: [f"{name}-{i}.gang:2222" for i in range(count)]
            for name, count in topology.items()
        }
        return {"TF_CONFIG": json.dumps(
            {"cluster": cluster, "task": {"type": replica, "index": idx}}
        )}
    if kind == V1RunKind.PYTORCHJOB:
        world = sum(topology.values())
        return {
            "MASTER_ADDR": "master-0.gang" if "master" in topology else "worker-0.gang",
            "MASTER_PORT": "23456",
            "WORLD_SIZE": str(world),
            "RANK": str(global_idx),
        }
    if kind == V1RunKind.MPIJOB:
        return {
            "OMPI_MCA_orte_keep_fqdn_hostnames": "true",
            "OMPI_COMM_WORLD_SIZE": str(sum(topology.values())),
            "OMPI_COMM_WORLD_RANK": str(global_idx),
        }
    if kind == V1RunKind.RAYJOB:
        head = "head" if "head" in topology else next(iter(topology))
        return {"RAY_ADDRESS": f"{head}-0.gang:6379",
                "RAY_NODE_RANK": str(global_idx)}
    if kind == V1RunKind.DASKJOB:
        sched = "scheduler" if "scheduler" in topology else next(iter(topology))
        return {"DASK_SCHEDULER_ADDRESS": f"tcp://{sched}-0.gang:8786"}
    return {}


def _compile_kubeflow(run, kind: str, plan_args, env_base):
    replica_map = run.replica_map()
    if not replica_map:
        raise CompilerError(f"{kind} requires at least one replica spec")
    topology = {name: (rep.replicas or 1) for name, rep in replica_map.items()}
    processes = []
    chips = 0
    accelerator = None
    global_idx = 0
    for name, rep in replica_map.items():
        cmd, args = _container_cmd(rep.container)
        for i in range(rep.replicas or 1):
            env = dict(env_base)
            env.update(_kf_env(kind, name, i, global_idx, topology))
            if rep.container and rep.container.env:
                env.update({e.name: str(e.value) for e in rep.container.env
                            if e.value is not None})
            processes.append(
                V1ProcessSpec(
                    index=global_idx, host_index=global_idx, replica_name=name,
                    command=cmd, args=args, env=env,
                    image=(rep.container.image if rep.container else None),
                )
            )
            global_idx += 1
        if rep.container and rep.container.resources:
            chips += rep.container.resources.tpu_chips() * (rep.replicas or 1)
        if rep.environment and rep.environment.tpu:
            accelerator = rep.environment.tpu.accelerator
    resources = V1ResourceRequest(
        resources={TPU_RESOURCE: chips} if chips else {},
        accelerator=accelerator, chips=chips, hosts=len(processes),
    )
    return resources, processes


def _compile_job(run, plan_args, env_base, *, service: bool = False):
    cmd, args = _container_cmd(run.container)
    env = dict(env_base)
    if run.container and run.container.env:
        env.update({e.name: str(e.value) for e in run.container.env if e.value is not None})
    tpu = run.environment.tpu if run.environment else None
    resources = V1ResourceRequest(
        resources=(run.container.resources.to_dict()
                   if run.container and run.container.resources else {}),
        accelerator=(tpu.accelerator if tpu else None),
        topology=(tpu.topology if tpu else None),
        preemptible=bool(tpu.preemptible) if tpu else False,
        chips=(tpu.total_chips() if tpu else 0),
        node_selector=(run.environment.node_selector if run.environment else None),
    )
    n = (run.replicas or 1) if service else 1
    processes = []
    for i in range(n):
        penv = dict(env)
        spec = V1ProcessSpec(
            index=i, command=cmd, args=args, env=penv,
            image=(run.container.image if run.container else None),
            working_dir=(run.container.working_dir if run.container else None),
            ports=(run.ports if service else None),
        )
        processes.append(spec)
    return resources, processes


def _build_phase(op: V1Operation, plan_args: dict[str, Any],
                 hub_resolver) -> Optional[V1InitPhase]:
    """Compile the operation's ``build:`` section into a pre-run init
    phase (SURVEY §2 "Polyflow IR" — upstream spawns a separate build
    run from the referenced builder component and gates the main run on
    it, patching the main container's image with the built destination;
    the embedded plane's equivalent is the same builder compiled INTO
    the launch plan, executed by the agent before the gang starts, so a
    build failure fails the run before any main process spawns).

    The builder is resolved from the component hub, patched with the
    section's ``runPatch``/presets, and rendered through the same
    param/globals context as a normal operation — so ``{{ params.* }}``
    in the builder's command resolves against the build params.
    """
    build = op.build
    if build is None:
        return None
    if not build.hub_ref:
        raise CompilerError(
            "`build` requires hubRef naming the builder component")
    if hub_resolver is None:
        raise CompilerError(
            f"cannot resolve build hubRef `{build.hub_ref}`: no component "
            "hub available (submit through the control plane)")
    try:
        builder = hub_resolver(build.hub_ref)
    except ValueError as exc:
        raise CompilerError(str(exc)) from exc

    from polyaxon_tpu_torch.polyaxonfile import (
        apply_presets,
        resolve_operation_context,
    )

    build_op = V1Operation(
        component=builder,
        params=build.params,
        run_patch=build.run_patch,
        patch_strategy=build.patch_strategy,
    )
    if build.presets:
        build_op = apply_presets(build_op, build.presets)
    try:
        resolved = resolve_operation_context(
            build_op,
            run_uuid=plan_args["run_uuid"],
            run_name=plan_args.get("run_name") or "",
            project_name=plan_args.get("project") or "",
        )
    except Exception as exc:
        raise CompilerError(
            f"build section failed to resolve: {exc}") from exc
    run = resolved.component.run
    container = getattr(run, "container", None)
    command, args = _container_cmd(container)
    if not command and not args:
        raise CompilerError(
            f"build component `{build.hub_ref}` has no container command")
    env: dict[str, str] = {}
    if container is not None and container.env:
        env.update({e.name: str(e.value) for e in container.env
                    if e.value is not None})
    env.update(_io_env(resolved))
    # Upstream convention: the builder's `destination` param names the
    # image the build produces; the main processes run that image.
    destination = None
    dest_param = (resolved.params or {}).get("destination")
    if dest_param is not None and isinstance(dest_param.value, str):
        destination = dest_param.value
    return V1InitPhase(
        kind="build",
        config={
            "hubRef": build.hub_ref,
            "command": command + args,
            "env": env,
            **({"destination": destination} if destination else {}),
        },
        connection=build.connection,
    )


def _referenced_connections(op: V1Operation, run) -> tuple[list[str], list[str]]:
    """(init connections — env injected into the gang,
    notifier/hook connections — validated only: their schemas can carry
    webhook URLs/secrets that must never reach user processes)."""
    init_names = []
    for init in getattr(run, "init", None) or []:
        if init.connection:
            init_names.append(init.connection)
    notify_names = []
    for notification in op.notifications or []:
        notify_names.extend(notification.connections or [])
    for hook in op.hooks or []:
        if hook.connection:
            notify_names.append(hook.connection)
    return list(dict.fromkeys(init_names)), list(dict.fromkeys(notify_names))


def compile_operation(
    op: V1Operation,
    *,
    run_uuid: str,
    artifacts_root: str,
    project: str = "default",
    store_dir: Optional[str] = None,
    catalog=None,  # connections.ConnectionCatalog
    hub_resolver=None,  # name -> V1Component (build: sections need it)
) -> V1LaunchPlan:
    """Resolved operation (literal params — run through
    ``resolve_operation_context`` first) → launch plan."""
    if op.component is None:
        raise CompilerError("Cannot compile an operation without a resolved component")
    component: V1Component = op.component
    run = component.run
    kind = component.run_kind

    artifacts_dir = os.path.join(artifacts_root, run_uuid)
    outputs_dir = os.path.join(artifacts_dir, "outputs")
    plan_args = {
        "run_uuid": run_uuid,
        "run_name": op.name or component.name,
        "project": project,
        "artifacts_dir": artifacts_dir,
        "outputs_dir": outputs_dir,
    }
    env_base = _base_env(plan_args)
    # Connection references resolve at compile time: a dangling name is a
    # compile error (SURVEY §2 "Connections"). Init connections inject
    # their env contract into the gang; notifier/hook connections are
    # validated (exist + can notify) but their env stays agent-side.
    init_conns, notify_conns = _referenced_connections(op, run)
    if init_conns or notify_conns:
        if catalog is None:
            from polyaxon_tpu_torch.connections import ConnectionCatalog

            catalog = ConnectionCatalog()
        from polyaxon_tpu_torch.connections import V1ConnectionKind

        try:
            env_base.update(catalog.env_for(init_conns))
            for name in notify_conns:
                conn = catalog.get(name)
                if not (conn.is_notifier or conn.kind == V1ConnectionKind.CUSTOM):
                    raise CompilerError(
                        f"connection `{name}` (kind={conn.kind}) cannot be "
                        "used for notifications/hooks")
        except CompilerError:
            raise
        except ValueError as exc:
            raise CompilerError(str(exc)) from exc
    env_base.update(_io_env(op))

    if kind == V1RunKind.JAXJOB:
        # plugins.capture_profile → a jax.profiler trace artifact
        # (SURVEY §5.1): inject profile steps into the builtin runtime.
        capture = None
        for plug in (op.plugins, component.plugins):
            if plug is not None and plug.capture_profile is not None:
                capture = plug.capture_profile
                break
        if capture is not None and capture is not False:
            if run.runtime is None:
                raise CompilerError(
                    "captureProfile needs the builtin jaxjob runtime; a "
                    "user container must call jax.profiler itself")
            if not run.runtime.get("profile_steps"):
                steps = capture.get("steps") if isinstance(capture, dict) else None
                if steps is None:
                    # Default profile step, clamped into short jobs so a
                    # 2-step run still produces a trace artifact.
                    total = run.runtime.get("steps")
                    steps = [min(3, total - 1) if isinstance(total, int)
                             and total > 1 else 3]
                elif isinstance(steps, int):
                    steps = [steps]
                elif not (isinstance(steps, list)
                          and all(isinstance(s, int) for s in steps)):
                    raise CompilerError(
                        f"captureProfile.steps must be an int or list of "
                        f"ints, got {steps!r}")
                run = run.clone()
                run.runtime = dict(run.runtime)
                run.runtime["profile_steps"] = steps
        resources, processes = _compile_jaxjob(run, plan_args, env_base)
    elif kind in (V1RunKind.TFJOB, V1RunKind.PYTORCHJOB, V1RunKind.MPIJOB,
                  V1RunKind.RAYJOB, V1RunKind.DASKJOB):
        resources, processes = _compile_kubeflow(run, kind, plan_args, env_base)
    elif kind in (V1RunKind.JOB, V1RunKind.NOTIFIER, V1RunKind.CLEANER,
                  V1RunKind.WATCHDOG):
        resources, processes = _compile_job(run, plan_args, env_base)
        interval = getattr(run, "interval_seconds", None)
        if kind == V1RunKind.WATCHDOG and interval:
            # Re-execute on the interval until stopped (utils.watchloop);
            # a failing iteration fails the run.
            for proc in processes:
                proc.command = [
                    "python", "-m", "polyaxon_tpu_torch.utils.watchloop",
                    str(interval), "--", *proc.command,
                ]
    elif kind == V1RunKind.SERVICE:
        resources, processes = _compile_job(run, plan_args, env_base, service=True)
    else:
        raise CompilerError(f"Run kind `{kind}` is not compilable to a launch plan")

    plugins = op.plugins or component.plugins
    termination = None
    if op.termination or component.termination:
        termination = (op.termination or component.termination).to_dict()

    init = _init_phases(run, plugins, catalog)
    build_phase = _build_phase(op, plan_args, hub_resolver)
    if build_phase is not None:
        # The build gates everything: first phase, before even auth —
        # upstream's build run completes before the main run exists.
        init.insert(0, build_phase)
        destination = build_phase.config.get("destination")
        if destination:
            for proc in processes:
                proc.image = destination

    return V1LaunchPlan(
        run_uuid=run_uuid,
        run_name=plan_args["run_name"],
        project=project,
        run_kind=kind,
        artifacts_dir=artifacts_dir,
        outputs_dir=outputs_dir,
        resources=resources,
        num_processes=len(processes),
        processes=processes,
        init=init,
        sidecars=_sidecars(run, plugins, artifacts_dir, store_dir),
        termination=termination,
        queue=op.queue or component.queue,
        labels=(run.environment.labels if getattr(run, "environment", None) else None),
    )
