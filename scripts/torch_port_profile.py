"""Where the time of the PyTorch port's main paths goes, on one NVIDIA GPU.

    python3 scripts/torch_port_profile.py [--chunks 1] [--paths dqn,rainbow,physics,sumtree,ppo,offpolicy,trust_region,distributional,offline]
    python3 scripts/torch_port_profile.py --compare PARENT_TREE [--pairs 10]

For the DQN-on-pixels pipeline of ``bench.py`` and then for the Rainbow +
prioritized-replay pipeline (``chip_smoke.build_pipeline``: 256 envs,
512-slot uint8 rings, batch 32, update_per_step 0.1, T=16), in
``tianshou_tpu_torch`` at full width: warms the pipeline up with a random
prefill and one training chunk, times ``--chunks`` chunks (collect 16 steps
+ 410 updates each) without the profiler, then traces as many more with
``torch.profiler``. Prints both wall times, the device's busy time from the
trace (the sum of its kernels' times; one stream, so they do not overlap),
the idle share against the unprofiled wall time (and, apart, against the
traced one, which the profiler's host overhead inflates), kernel launches
per update, and the kernels that take the most device time, with the card's
name and power limit.

For the prioritized replay it then traces its parts alone, 50 calls each at
the main path's shapes, and prints the kernel launches and device time per
call of the stratified sampler, the weights, the priority writeback (a tree
update of 32 leaves) and the collector's max-priority write (256 leaves), so
that their share of an update's launches can be read off.

For the sum tree alone (``--paths sumtree``, on the main path's tree of
131072 leaves) it times the descent kernel at 32 and 4096 values for each
launch shape it takes (log2 lanes per query, levels per trip, warps per
block; one lane and one level per trip is the old kernel's walk)
and the update kernel against its plain version at 1 to 1024 leaves (one
launch) and above (one launch per 1024 leaves), each a replayed CUDA graph.

For the physics paths (``VectorDeviceEnv`` of HalfCheetah and of Ant at 2048
envs, random actions: ``bench.py:bench_physics_step``; then HalfCheetah under
``contact_model="penalty"``, the kernel's penalty branch, and Humanoid, which
steps through the plain ``dynamics.step``) it times 64 (Ant: 16, Humanoid:
``chip_smoke.HUM_T``) vector steps without the profiler and traces as many more: wall time per
vector step, device busy time, idle share, launches per step, and how the
device time of one ``venv.step`` splits between the fused step kernel and the
small kernels around it (action sampling, clip, reward, observation,
termination). Then the kernel alone on the path's last states (device time
from a replayed CUDA graph): against the number of envs (32 to 33792), with
the contact solver's iterations at 0 and at the task's count, and against
what the launch exposes: lanes per env (``TEAM``, one library each) and envs
per block. The same sweep then runs for the four tasks that have no path here,
on states 32 random-action steps from reset.

For the on-policy paths (``--paths ppo``) it traces one PPO megastep of
``chip_smoke``'s ``bench_mujoco_ppo`` twin (HalfCheetah and Ant, 2048 envs,
one CUDA graph of collect and update): wall, device busy time, idle share
and the device kernels by class (the physics kernel, GEMMs, the optimizer's
multi-tensor kernels, sorts, reductions, indexing, the rest); then the
MuJoCo example's update graph with and without ``target_kl`` on one
rollout, for what the KL guard costs per minibatch.

For the continuous off-policy paths (``--paths offpolicy``: ``chip_smoke``'s
``sac_halfcheetah``, ``td3_ant_per`` and ``redq_halfcheetah``, 32 envs, T 4,
128 updates of batch 256 per megastep, 256x256 nets) it fills the replay with
random steps, then times and traces one megastep (collect and burst, one CUDA
graph) and one burst alone (the trainer's ``update_burst``): wall, device busy
time, the idle share of the traced call alone (busy against its kernels' span
from first start to last end, and against its wall), host launches, device kernels and device ms per update, the
kernels by class and ``physics_fused``'s share of the busy time.

For the trust-region paths (``--paths trust_region``: ``chip_smoke``'s ``npg_halfcheetah`` and
``trpo_halfcheetah`` widths, 16 envs of ``NormObs(HalfCheetah())``, T 64, one update of 1,024 rows
with 20 critic steps) it times and traces the collect chunk and the update, each a replayed CUDA
graph: device busy time, kernels and their classes. The update is traced again with no
conjugate-gradient iterations (``cg_iters`` 0: the search direction is 0 and one Fisher product
remains) and, for TRPO, with no line-search candidates (``max_backtracks`` 0): the differences are
the conjugate gradient's and the line search's shares of the update. Then ``chip_smoke``'s
``bench_mlp_ppo`` twin's megastep (PPO CartPole, 4,096 envs, T 128) traced the same way.

For the distributional and discrete Q family (``--paths distributional``: ``chip_smoke``'s ``qrdqn``,
``iqn``, ``fqf`` and ``discrete_sac`` pipelines at bench.py's widths) it traces one replayed update burst
of each (410 updates of batch 32 after a random prefill): kernels per update, device ms per update and by
kernel class, and the ``gather_rows`` kernels' launches and share of the busy time.

For the offline pixel paths (``--paths offline``: ``chip_smoke``'s ``offline_{bcq,cql,crr}_pixels``, discrete
BCQ, CQL and CRR at bench.py's widths from the ring the DQN pipeline's collector fills at eps 0.2) it traces one
replayed burst of ``OfflineTrainer.BURST`` updates the same way.

The pixel paths run through one trainer: a warm-up run of the prefill and two
chunks (where the trainer captures its CUDA graphs: a program's first call is
its eager warm-up, the second its capture), then the timed and the traced
runs, which replay.

``--compare PARENT_TREE`` holds this tree against another checkout of the
port (an unpacked ``git archive`` of the parent commit, say) on the card, in
turns: ``--pairs`` pairs of processes, parent then this tree, then this tree
then parent, and so on, because the host's speed drifts within a call. Each
process (``--measure --tree ROOT``, which imports ``chip_smoke`` and
``tianshou_tpu_torch`` from ROOT) measures the four paths of ``bench.py``
once, through whatever programs its tree has: the DQN and the Rainbow + PER
pixel paths (one chunk timed, one traced: wall per chunk, env-steps/s, ms
per update, device busy time per chunk, idle share against the unprofiled
wall, the host's launches per update, kernel and CUDA graph launches both,
and device kernels per update); and the HalfCheetah (64 steps) and Ant (16 steps) rollouts at 2048 envs (one graph of
the whole rollout, ``chip_smoke.rollout_program``, where the tree has it, an
eager loop where it has not): the same per vector step. It prints every process's numbers and then,
per path and tree, the median and the range, and writes them all to
``chiprun_out/profile_pairs_<paths>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
chip_smoke = None  # imported in main(), from the tree that --tree names


def _device_events(prof) -> dict[str, list[float]]:
    """Device-side kernel times by name, less the user annotations that mirror CPU ops on the
    device timeline (e.g. "Optimizer.step#Adam.step"), which span kernels counted on their own."""
    import torch

    per_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            per_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return per_name


def _host_launches(prof) -> int:
    """Launches the host issued in a trace: CUDA runtime or driver calls that launch a kernel or a graph."""
    import torch

    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
               and ("LaunchKernel" in e.name or "GraphLaunch" in e.name))


def profile_path(kind: str, chunks: int, smi: str):
    """Time and trace ``chunks`` update chunks of the pipeline of ``kind``; returns its buffer,
    buffer state and generator for the traces of the parts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    E, T, batch = chip_smoke.E, chip_smoke.T, chip_smoke.BATCH
    algo, ts, buffer, buf_state, coll = chip_smoke.build_pipeline(torch, kind)
    gen = torch.Generator(device="cuda").manual_seed(0)

    params = OffPolicyTrainerParams(
        max_epochs=1, epoch_num_steps=2 * T * E, batch_size=batch,
        collection_step_num_env_steps=T, update_per_step=0.1, start_steps=T * E, verbose=False,
    )
    trainer = OffPolicyTrainer(algo, coll, None, buffer, params)
    res = trainer.run(ts, buf_state, gen)  # warm-up: cuDNN plans, allocator, the graphs' capture
    params.start_steps, params.epoch_num_steps = 0, chunks * T * E
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.run(res.train_state, res.buf_state, gen)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_timing = dict(res.timing)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = trainer.run(res.train_state, res.buf_state, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_name = _device_events(prof)
    busy_us = sum(sum(v) for v in per_name.values())
    launches = sum(len(v) for v in per_name.values())
    updates = chunks * max(1, round(0.1 * T * E))
    print(f"== {kind} path ==")
    print(f"device: {smi}")
    print(f"profiled {chunks} chunk(s): {chunks * T * E} env steps, {updates} updates")
    print(f"wall ms without the profiler {plain_wall * 1e3:.1f} (collect {plain_timing['collect'] * 1e3:.1f}, "
          f"update {plain_timing['update'] * 1e3:.1f} = {plain_timing['update'] / max(updates, 1) * 1e3:.3f} per update)")
    print(f"wall ms under the profiler {wall * 1e3:.1f} (collect {res.timing['collect'] * 1e3:.1f}, "
          f"update {res.timing['update'] * 1e3:.1f})")
    print(f"device busy ms {busy_us / 1e3:.1f}, idle share {1 - busy_us / 1e3 / (plain_wall * 1e3):.3f} "
          f"against the wall time without the profiler ({1 - busy_us / 1e3 / (wall * 1e3):.3f} under it), "
          f"kernel launches {launches} ({launches / max(updates, 1):.1f} per update incl. collect), host launches "
          f"{_host_launches(prof) / max(updates, 1):.2f} per update (kernels and CUDA graphs)")
    print("top kernels by device time: total_ms, calls, mean_us, name")
    for name, v in sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:15]:
        print(f"  {sum(v) / 1e3:9.2f} {len(v):7d} {sum(v) / len(v):9.2f}  {name[:110]}")
    return buffer, res.buf_state, gen


def profile_per_parts(buffer, state, gen, smi: str, calls: int = 50) -> None:
    """Kernel launches and device time per call of each part of the prioritized replay, at the
    main path's shapes (a tree of 131072 leaves, batch 32, 256 envs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch, E = chip_smoke.BATCH, chip_smoke.E
    idx = buffer.sample_indices(state, gen, batch)
    td = torch.rand(batch, device="cuda", generator=gen)
    new = torch.randint(0, buffer.total_size, (E,), device="cuda", generator=gen)
    prio = torch.ones(E, device="cuda")
    parts = {
        "sample_indices (uniforms, strata, sum-tree kernel)": lambda: buffer.sample_indices(state, gen, batch),
        "get_weight": lambda: buffer.get_weight(state, idx),
        f"update_weight (tree update of {batch} leaves)": lambda: buffer.update_weight(state, idx, td),
        f"segtree.update of {E} leaves (the collector's add)": lambda: buffer.segtree.update(state.tree, new, prio),
    }
    print(f"== parts of the prioritized replay, {calls} calls each [{smi}] ==")
    print("part: kernel launches per call, device us per call, wall us per call")
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / calls * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per_name = _device_events(prof)
        n = sum(len(v) for v in per_name.values())
        print(f"  {name}: {n / calls:.1f} launches, {sum(sum(v) for v in per_name.values()) / calls:.1f} us device, "
              f"{wall_us:.1f} us wall (without the profiler)")


def profile_sumtree(smi: str) -> None:
    """The descent kernel by launch shape and the update kernel by leaves, on a full main-path tree."""
    import torch

    from tianshou_tpu_torch.ops.kernels import sumtree
    from tianshou_tpu_torch.ops.segtree import SegmentTree

    def ms(fn):
        return chip_smoke._time_ms(fn, warmup=5, runs=20, per_graph=20)[0]

    g = torch.Generator(device="cuda").manual_seed(0)
    st = SegmentTree(chip_smoke.E * chip_smoke.SLOTS)
    tree = sumtree.update_reference(st.init("cuda"), torch.arange(st.size, device="cuda"),
                                    torch.rand(st.size, device="cuda", generator=g) + 1e-3, st.bound, st.depth, st.size)
    print(f"== sum tree, bound {st.bound} (depth {st.depth}), device us per call (CUDA graph of 20, median of 20) [{smi}] ==")
    shapes = [(h, per_trip, warps) for h in range(6) for per_trip in range(max(1, h - 1), h + 5) for warps in (4, 8)]
    for b in (32, 4096):
        values = ((torch.rand(b, device="cuda", generator=g) + torch.arange(b, device="cuda")) / b * st.total(tree)).contiguous()
        want = sumtree.prefix_sum_idx_reference(tree, values, st.bound, st.depth, st.size)
        cells = []
        for shape in shapes:
            if not torch.equal(sumtree._descent(tree, values, st.bound, st.depth, st.size, shape), want):
                raise AssertionError(f"prefix_sum_idx shape {shape} differs from its plain version")
            cells.append(f"{shape} {ms(lambda: sumtree._descent(tree, values, st.bound, st.depth, st.size, shape)) * 1e3:.3f}")
        rule = sumtree._descent_shape(b)
        cells.append(f"the rule {rule} {ms(lambda: sumtree.prefix_sum_idx(tree, values, st.bound, st.depth, st.size)) * 1e3:.3f}")
        print(f"  prefix_sum_idx B={b}, (log2 lanes per query, levels per trip, warps per block) us: " + ", ".join(cells))
    for k in (1, 32, 256, 1024, 1025, 4096, st.size):
        index = torch.randint(-1, st.size, (k,), device="cuda", generator=g)
        value = torch.rand(k, device="cuda", generator=g) + 0.5
        launches = sumtree.update_launch_count()
        kern = ms(lambda: sumtree.update(tree, index, value, st.bound, st.depth, st.size))
        per_call = (sumtree.update_launch_count() - launches) / (5 + 20 + 20)  # warm-up, eager runs, captured calls
        # the plain version clears node 0 from a host scalar, which a CUDA graph cannot capture: eager time
        plain = chip_smoke._time_ms(lambda: sumtree.update_reference(tree, index, value, st.bound, st.depth, st.size),
                                    warmup=5, runs=20, per_graph=0)[1]
        print(f"  tree_update k={k}: kernel {kern * 1e3:.3f} us ({per_call:.0f} launches per call), plain {plain * 1e3:.3f} us (eager)")


def profile_physics(task: str, steps: int, smi: str, penalty: bool = False) -> None:
    """Time and trace ``steps`` vector steps of the physics path of ``task`` (with ``penalty``, under
    ``contact_model="penalty"``); then the kernel's sweep, for a task that steps through the kernel under
    the constraint model (Humanoid takes the plain route: no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make

    E = chip_smoke.PHYS_E
    venv = VectorDeviceEnv(make(task), E, device="cuda")
    if penalty:
        venv.env.model.contact_model = "penalty"
    route = getattr(venv.env, "physics_route", "kernel")
    state, program, graphed = rollout_program(venv, steps)
    for _ in range(2):  # warm-up: library load, local memory, allocator; the graph's eager call and capture
        program()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        program()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name = _device_events(prof)
    busy_us = sum(sum(v) for v in per_name.values())
    launches = sum(len(v) for v in per_name.values())
    fused = {k: v for k, v in per_name.items() if "fused_step_kernel" in k}
    fused_us = sum(sum(v) for v in fused.values())
    print(f"== {task}{' penalty' if penalty else ''} physics path ({'one CUDA graph of the rollout' if graphed else 'eager'}"
          f", {route} route) ==")
    print(f"device: {smi}")
    print(f"host launches per step {_host_launches(prof) / steps:.2f} (kernels and CUDA graphs)")
    print(f"E={E}, {steps} vector steps: wall us per step without the profiler {plain_wall / steps * 1e6:.1f} "
          f"({steps * E / plain_wall:.1f} env-steps/s), under it {wall / steps * 1e6:.1f}")
    print(f"device busy us per step {busy_us / steps:.1f}, idle share {1 - busy_us / 1e6 / plain_wall:.3f} against the "
          f"wall time without the profiler ({1 - busy_us / 1e6 / wall:.3f} under it), kernel launches per step {launches / steps:.1f}")
    print(f"fused step kernel: {sum(len(v) for v in fused.values()) / steps:.2f} launches and {fused_us / steps:.1f} us per step, "
          f"{fused_us / max(busy_us, 1e-9):.4f} of device busy time; everything else (sampling, clip, reward, observation, "
          f"termination): {(launches - sum(len(v) for v in fused.values())) / steps:.1f} launches and "
          f"{(busy_us - fused_us) / steps:.1f} us per step")
    print("top kernels by device time: total_ms, calls, mean_us, name")
    for name, v in sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:8]:
        print(f"  {sum(v) / 1e3:9.2f} {len(v):7d} {sum(v) / len(v):9.2f}  {name[:110]}")
    if route == "kernel" and not penalty:
        kernel_scaling(venv.env, state, smi)


def rollout_program(venv, steps: int):
    """``(state, program, graphed)``: ``program()`` runs ``steps`` vector steps of ``venv`` with random
    actions on ``state``, in place: ``chip_smoke.rollout_program``, one CUDA graph, where the tree has
    it, else (a tree from before the graphs) an eager loop."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    if hasattr(chip_smoke, "rollout_program"):
        return (*chip_smoke.rollout_program(torch, venv, steps, gen)[:2], True)
    from tianshou_tpu_torch.utils.tree import tree_map

    state, _ = tree_map(torch.clone, venv.reset(gen))

    def rollout():
        s = state
        for _ in range(steps):
            s = venv.step(s, venv.action_space.sample(venv.num_envs, gen, venv.device), gen).state
        tree_map(torch.Tensor.copy_, state, s)

    return state, rollout, False


def kernel_scaling(env, state, smi: str) -> None:
    """How the fused step kernel's time moves with the number of envs, with the contact solver's
    iterations, and with the launch's shape (lanes per env, envs per block), on states of the
    path just run (tiled or cut to the env count)."""
    import torch

    from tianshou_tpu_torch.ops.kernels import _build
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    model, fs = env.model, env.frame_skip
    iters = int(model.contact_iterations)
    nu = len(model.actuators)

    def ms(q, qd, ctrl):
        return chip_smoke._time_ms(lambda: pf.fused_step(model, q, qd, ctrl, frame_skip=fs), warmup=2, runs=8, per_graph=3)[0]

    info = pf.kernel_info(model)
    print(f"fused step kernel of {type(env).__name__}, ms per call (CUDA graph of 3 calls, median of 8) [{smi}]; default launch: "
          f"TEAM {info['team']}, {info['envs_per_block']} envs per block, {info['shared_bytes_per_env']} B of shared memory per env, "
          f"{info['rows_in_shared']} QP rows in shared memory")
    for E in (32, 256, 2048, 4224, 8448, 33792):
        reps = -(-E // state.q.shape[0])
        q, qd = state.q.repeat(reps, 1)[:E].contiguous(), state.qd.repeat(reps, 1)[:E].contiguous()
        ctrl = torch.zeros(E, nu, device="cuda")
        cells = []
        for n in sorted({0, iters}):
            model.contact_iterations = n
            cells.append(f"{n} iterations {ms(q, qd, ctrl):.4f}")
        model.contact_iterations = iters
        print(f"  E={E}: " + ", ".join(cells))
    E = chip_smoke.PHYS_E
    q, qd, ctrl = state.q[:E].contiguous(), state.qd[:E].contiguous(), torch.zeros(E, nu, device="cuda")
    teams = (4, 8, 16, 32)
    # one compiler per team size and one for the build with cycle counters, all together
    _build.build(*(pf.build_target(model, t) for t in teams), pf.build_target(model, None, True))
    default = (pf._TEAM, pf._ENVS_PER_BLOCK)
    for team in teams:
        pf._TEAM, cells = team, []
        for n in (1, 2, 4, 8, 16, 4):  # 4 again at the end shows the drift within the sweep
            pf._ENVS_PER_BLOCK = n
            cells.append(f"{pf.kernel_info(model)['envs_per_block']}: {ms(q, qd, ctrl):.4f}")
        print(f"  E={E}, TEAM {team}, by envs per block: " + ", ".join(cells))
    pf._TEAM, pf._ENVS_PER_BLOCK = default

    # where one warp's time goes: cycle counters of a profiling build, at 32 envs so that nothing else runs beside it
    pf._PROFILE = True
    q, qd, ctrl = state.q[:32].contiguous(), state.qd[:32].contiguous(), torch.zeros(32, nu, device="cuda")
    pf.fused_step(model, q, qd, ctrl, frame_skip=fs)  # warm-up
    pf.phase_cycles(model)
    pf.fused_step(model, q, qd, ctrl, frame_skip=fs)
    torch.cuda.synchronize()
    cycles = pf.phase_cycles(model)
    pf._PROFILE = False
    from tianshou_tpu_torch.env.physics import dynamics
    n_sub = fs * dynamics.resolve_substeps(model, env.substeps)
    total = sum(cycles.values())
    print(f"  E=32, cycles of env 0's warp per substep by phase (profiling build, {n_sub} substeps, {total / n_sub:.0f} in all; "
          f"a phase's time includes waiting for the envs that share the warp): "
          + ", ".join(f"{name} {c / n_sub:.0f} ({c / total:.3f})" for name, c in cycles.items()))


def rollout_state(task: str, steps: int = 32):
    """(env, state) of ``task`` at 2048 envs, ``steps`` random-action vector steps from reset."""
    import torch

    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make

    venv = VectorDeviceEnv(make(task), chip_smoke.PHYS_E, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = venv.reset(gen)
    for _ in range(steps):
        state = venv.step(state, venv.action_space.sample(chip_smoke.PHYS_E, gen, venv.device), gen).state
    torch.cuda.synchronize()
    return venv.env, state


def _trace(fn, torch):
    """(wall s without the profiler, wall s under it, device busy us, device kernels, host launches) of
    ``fn()``. The trace records the device's activity and the CUDA runtime's calls only, not PyTorch's
    operators, which would multiply its events (and the time to read them back) several times over."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    # the raw events: building the profiler's own event objects for ~300,000 events takes tens of seconds
    busy_ns = kernels = host = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                busy_ns, kernels = busy_ns + e.duration_ns(), kernels + 1
        elif "LaunchKernel" in e.name() or "GraphLaunch" in e.name():
            host += 1
    return plain, traced, busy_ns / 1e3, kernels, host


def _trace_kernels(fn, torch) -> tuple[float, float, dict[str, list[float]], int, float]:
    """(wall s without the profiler, wall s under it, {kernel name: [device us]}, host launches, device
    span us: the traced call's first kernel start to its last kernel end) of ``fn()``, the trace read as
    in :func:`_trace`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    per_name: dict[str, list[float]] = {}
    host, first, last = 0, float("inf"), float("-inf")
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                per_name.setdefault(e.name(), []).append(e.duration_ns() / 1e3)
                first, last = min(first, e.start_ns()), max(last, e.start_ns() + e.duration_ns())
        elif "LaunchKernel" in e.name() or "GraphLaunch" in e.name():
            host += 1
    return plain, traced, per_name, host, max(last - first, 0) / 1e3


def _kernel_classes(per_name: dict[str, list[float]]) -> dict[str, tuple[int, float]]:
    """Device kernels by class (name patterns): {class: (launches, us)}."""
    classes = (("physics_fused", ("fused_step_kernel",)), ("gemm", ("gemm", "cutlass", "sm90_", "cublas", "gemv")),
               ("optimizer (multi-tensor)", ("multi_tensor", "foreach")), ("sort", ("sort", "radix")),
               ("reduction", ("reduce",)), ("index / gather / scatter", ("index", "gather", "scatter")))
    out: dict[str, tuple[int, float]] = {}
    for name, times in per_name.items():
        cls = next((c for c, keys in classes if any(k in name.lower() for k in keys)), "other (elementwise, copies)")
        n, us = out.get(cls, (0, 0.0))
        out[cls] = (n + len(times), us + sum(times))
    return out


def profile_ppo(smi: str) -> None:
    """Where the time of the on-policy paths goes. For ``chip_smoke``'s PPO megastep (the
    ``bench.py:bench_mujoco_ppo`` twin, HalfCheetah at T = 32 and Ant at T = 16, 2048 envs; one CUDA
    graph of collect and update) one megastep timed and one traced: wall, device busy time, idle
    share, host launches, device kernels by class. Then the MuJoCo example's update (16 envs, a
    rollout of 128, 10 passes of batch 64, ``recompute_advantage``) as a graph with and without
    ``target_kl`` on the same rollout and state: what the KL guard's copies and selects cost per
    minibatch."""
    import copy

    import torch

    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    for task, steps in chip_smoke.PPO_PATHS:
        algo, ts, coll = chip_smoke.build_ppo(torch, task, chip_smoke.PPO_E)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cstate = coll.reset(gen)

        def megastep():
            out = coll.rollout(ts, cstate, None, gen, steps, keep_rollout=True)
            return algo.update_rollout(ts, out.rollout, gen, chip_smoke.PPO_REPEAT, chip_smoke.PPO_BATCH)[1]

        program = Graphed(megastep, GraphPool("cuda"), (gen,), name="ppo_megastep")
        program(), program()  # eager warm-up, capture
        plain, traced, per_name, host, _ = _trace_kernels(program, torch)
        busy = sum(sum(v) for v in per_name.values())
        print(f"== ppo_{task.lower()} megastep (E={chip_smoke.PPO_E}, T={steps}, one CUDA graph) ==")
        print(f"device: {smi}")
        print(f"wall ms {plain * 1e3:.3f} without the profiler ({steps * chip_smoke.PPO_E / plain:.1f} env-steps/s), "
              f"{traced * 1e3:.3f} under it; device busy ms {busy / 1e3:.3f}, idle share {1 - busy / 1e6 / plain:.3f} "
              f"({1 - busy / 1e6 / traced:.3f} under the profiler); device kernels {sum(len(v) for v in per_name.values())}, "
              f"host launches {host}")
        for cls, (n, us) in sorted(_kernel_classes(per_name).items(), key=lambda kv: -kv[1][1]):
            print(f"  {cls}: {n} kernels, {us / 1e3:.3f} ms ({us / busy:.3f} of busy)")

    kw = dict(lr=3e-4, ppo_init=True, advantage_normalization=False, recompute_advantage=True, vf_coef=0.25,
              ent_coef=0.0)
    times = {}
    for guard in (None, 0.015):
        algo, ts, coll = chip_smoke.build_ppo(torch, "HalfCheetah", chip_smoke.MJ_E, target_kl=guard, **kw)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cstate = coll.reset(gen)
        rollout = coll.rollout(ts, cstate, None, gen, chip_smoke.MJ_T, keep_rollout=True).rollout
        state = copy.deepcopy(ts)

        def update():
            return algo.update_rollout(state, rollout, gen, chip_smoke.MJ_REPEAT, chip_smoke.MJ_BATCH)[1]

        program = Graphed(update, GraphPool("cuda"), (gen,), name="update")
        program(), program()
        plain, _, per_name, _, _ = _trace_kernels(program, torch)
        n_mb = chip_smoke.MJ_REPEAT * algo.minibatch_shape(chip_smoke.MJ_E * chip_smoke.MJ_T, chip_smoke.MJ_BATCH)[0]
        busy = sum(sum(v) for v in per_name.values())
        times[guard] = (plain, busy, sum(len(v) for v in per_name.values()), n_mb)
    (p0, b0, k0, n_mb), (p1, b1, k1, _) = times[None], times[0.015]
    print(f"== the MuJoCo example's update (E={chip_smoke.MJ_E}, T={chip_smoke.MJ_T}, {n_mb} minibatches of "
          f"{chip_smoke.MJ_BATCH}, recompute_advantage), one CUDA graph ==")
    print(f"device: {smi}")
    print(f"without target_kl: wall ms {p0 * 1e3:.3f}, device busy ms {b0 / 1e3:.3f}, {k0} kernels "
          f"({k0 / n_mb:.1f} and {b0 / n_mb:.1f} us per minibatch)")
    print(f"with target_kl 0.015: wall ms {p1 * 1e3:.3f}, device busy ms {b1 / 1e3:.3f}, {k1} kernels "
          f"({k1 / n_mb:.1f} and {b1 / n_mb:.1f} us per minibatch); the guard adds {(k1 - k0) / n_mb:.1f} kernels and "
          f"{(b1 - b0) / n_mb:.1f} us of device time per minibatch")


def profile_offpolicy(smi: str, prefill_chunks: int = 40) -> None:
    """Where the time of the continuous off-policy paths goes: for each path of ``chip_smoke.OFF_PATHS``
    at its widths, after ``prefill_chunks`` random collect chunks, one megastep (collect and the burst
    of 128 updates, one CUDA graph) and one burst alone, each called for its eager warm-up and its
    capture, then timed and traced."""
    import torch

    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    cs = chip_smoke
    for name, (task, kind, _, _, prio) in cs.OFF_PATHS.items():
        torch.manual_seed(0)
        env = make(task)
        algo = cs.make_offpolicy(torch, kind, env, cs.OFF_HID, **cs.OFF_ALGOS[kind])
        ts = algo.init("cuda")
        buffer, bs = cs.offpolicy_buffer(torch, env, cs.OFF_BUFFER, cs.OFF_E, prio)
        coll = DeviceCollector(VectorDeviceEnv(env, cs.OFF_E, device="cuda"), algo, buffer)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cstate = coll.reset(gen)
        for _ in range(prefill_chunks):
            coll.collect(ts, cstate, bs, gen, cs.OFF_T, random=True)
        trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(
            batch_size=cs.OFF_BATCH, collection_step_num_env_steps=cs.OFF_T, verbose=False))
        n_updates = cs.OFF_T * cs.OFF_E
        programs = {"megastep": lambda: trainer.megastep(ts, cstate, bs, gen, cs.OFF_T, n_updates),
                    "burst": lambda: trainer.update_burst(ts, bs, gen, n_updates)}
        print(f"== {name}: {kind} on {task}, E={cs.OFF_E}, T={cs.OFF_T}, {n_updates} updates of batch {cs.OFF_BATCH}"
              f"{', PER' if prio else ''} ==")
        print(f"device: {smi}")
        for part, fn in programs.items():
            fn(), fn()  # eager warm-up, capture
            plain, traced, per_name, host, span = _trace_kernels(fn, torch)
            busy = sum(sum(v) for v in per_name.values())
            kernels = sum(len(v) for v in per_name.values())
            classes = _kernel_classes(per_name)
            phys = classes.get("physics_fused", (0, 0.0))
            # both idle shares from the traced call alone: busy against its kernels' span and against its wall
            print(f"{part}: wall ms {plain * 1e3:.3f} without the profiler, {traced * 1e3:.3f} under it; device busy ms "
                  f"{busy / 1e3:.3f} over a span of {span / 1e3:.3f} ms, idle share {1 - busy / span:.4f} of the span "
                  f"({1 - busy / 1e6 / traced:.4f} of the traced wall); device kernels {kernels} ({kernels / n_updates:.1f} per update), device ms per update "
                  f"{busy / 1e3 / n_updates:.4f}; host launches {host}; physics_fused {phys[0]} launches, "
                  f"{phys[1] / busy:.3f} of busy")
            for cls, (n, us) in sorted(classes.items(), key=lambda kv: -kv[1][1]):
                print(f"  {cls}: {n} kernels, {us / 1e3:.3f} ms ({us / busy:.3f} of busy)")


def _report_burst(title: str, burst, n_updates: int, smi: str) -> None:
    """Trace ``burst()`` (a replayed update burst of ``n_updates`` updates) and print its kernels per update,
    device ms per update and by kernel class, and the ``gather_rows`` kernels' launches and share of busy time."""
    import torch

    plain, traced, per_name, host, span = _trace_kernels(burst, torch)
    busy = sum(sum(v) for v in per_name.values())
    kernels = sum(len(v) for v in per_name.values())
    gathers = [t for name, v in per_name.items() if "gather_spread_kernel" in name or "gather_bytes_kernel" in name
               for t in v]  # csrc/gather.cu's kernels
    print(f"== {title} ==")
    print(f"device: {smi}")
    print(f"burst: wall ms {plain * 1e3:.3f} without the profiler ({plain * 1e3 / n_updates:.4f} per update), "
          f"{traced * 1e3:.3f} under it; device busy ms {busy / 1e3:.3f}, idle share {1 - busy / 1e6 / plain:.4f} "
          f"against the wall without the profiler ({1 - busy / span:.4f} of the traced span of {span / 1e3:.3f} ms, "
          f"which the tracer stretches); device kernels {kernels} ({kernels / n_updates:.1f} per update), "
          f"device ms per update {busy / 1e3 / n_updates:.4f}; host launches {host}; gather_rows {len(gathers)} "
          f"kernels ({len(gathers) / n_updates:g} per update), {sum(gathers) / busy:.4f} of busy")
    for cls, (n, us) in sorted(_kernel_classes(per_name).items(), key=lambda kv: -kv[1][1]):
        print(f"  {cls}: {n} kernels ({n / n_updates:.1f} per update), {us / 1e3:.3f} ms ({us / busy:.3f} of busy)")
    print("  top kernels by device time: total_ms, calls, mean_us, name")
    for name, v in sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:8]:
        print(f"    {sum(v) / 1e3:9.3f} {len(v):7d} {sum(v) / len(v):9.2f}  {name[:100]}")


def profile_distributional(smi: str, prefill_chunks: int = 4) -> None:
    """Where the update time of the distributional and discrete Q family goes: for each pipeline of
    ``chip_smoke.DIST_KINDS`` at bench.py's widths, after ``prefill_chunks`` random collect chunks of T
    steps, one update burst of the chunk's 410 updates as the trainer's CUDA graph (its eager warm-up and
    its capture first), replayed once untraced and once traced (``_report_burst``)."""
    import torch

    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    cs = chip_smoke
    n_updates = max(1, round(0.1 * cs.T * cs.E))
    for kind in cs.DIST_KINDS:
        algo, ts, buffer, bs, coll = cs.build_pipeline(torch, kind)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cstate = coll.reset(gen)
        for _ in range(prefill_chunks):
            coll.collect(ts, cstate, bs, gen, cs.T, random=True)
        trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(
            batch_size=cs.BATCH, collection_step_num_env_steps=cs.T, verbose=False))

        def burst():
            trainer.update_burst(ts, bs, gen, n_updates)

        burst(), burst()  # eager warm-up, capture
        _report_burst(f"{kind}: the pixel pipeline at E={cs.E}, an update burst of {n_updates} updates of batch "
                      f"{cs.BATCH}", burst, n_updates, smi)
        del algo, ts, buffer, bs, coll, trainer
        torch.cuda.empty_cache()


def profile_offline(smi: str) -> None:
    """Where the update time of the offline pixel paths goes: the ring of ``chip_smoke.fill_offline_ring``, then
    for each of ``chip_smoke.OFFLINE_KINDS`` one burst of ``OfflineTrainer.BURST`` updates
    as its CUDA graph (eager warm-up and capture first), replayed once untraced and once traced."""
    import torch

    from tianshou_tpu_torch.trainer.trainer import OfflineTrainer, OfflineTrainerParams

    cs = chip_smoke
    buffer, bs, space, line = cs.fill_offline_ring(torch)
    print(line)
    for kind in cs.OFFLINE_KINDS:
        algo = cs.build_offline(torch, kind, space)
        ts = algo.init("cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        trainer = OfflineTrainer(algo, buffer, None, OfflineTrainerParams(batch_size=cs.BATCH, verbose=False))

        def burst():
            trainer.update_burst(ts, bs, gen, trainer.BURST)

        burst(), burst()  # eager warm-up, capture
        _report_burst(f"offline_{kind}_pixels: {type(algo).__name__} from the offline ring (E={cs.E}, "
                      f"{cs.SLOTS} slots), an update burst of {trainer.BURST} updates of batch {cs.BATCH}", burst,
                      trainer.BURST, smi)
        del algo, ts, trainer
        torch.cuda.empty_cache()


def measure(paths: set[str]) -> dict:
    """The four paths of bench.py once each, through the programs of the tree imported: per path
    wall ms per chunk (or us per vector step), env-steps/s, device busy time, idle share, host
    launches and device kernels per update (or per step)."""
    import torch

    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    E, T, batch = chip_smoke.E, chip_smoke.T, chip_smoke.BATCH
    n_updates = max(1, round(0.1 * T * E))
    graphed = hasattr(OffPolicyTrainer, "update_burst")  # a tree with the trainer's CUDA graphs
    out = {}
    for kind in ("dqn", "rainbow"):
        if kind not in paths:
            continue
        algo, ts, buffer, bs, coll = chip_smoke.build_pipeline(torch, kind)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = OffPolicyTrainerParams(max_epochs=1, epoch_num_steps=(2 if graphed else 1) * T * E,
                                        batch_size=batch, collection_step_num_env_steps=T, update_per_step=0.1,
                                        start_steps=T * E, verbose=False)
        trainer = OffPolicyTrainer(algo, coll, None, buffer, params)
        t0 = time.perf_counter()
        trainer.run(ts, bs, gen)  # warm-up (and where there are graphs, their capture)
        params.start_steps, params.epoch_num_steps = 0, T * E
        plain, traced, busy, kernels, host = _trace(lambda: trainer.run(ts, bs, gen), torch)
        out[kind] = {
            "seconds": time.perf_counter() - t0,
            "wall_ms_per_chunk": plain * 1e3, "env_steps_per_s": T * E / plain, "ms_per_update": plain / n_updates * 1e3,
            "device_busy_ms_per_chunk": busy / 1e3, "idle_share": 1 - busy / 1e6 / plain,
            "idle_share_traced": 1 - busy / 1e6 / traced, "host_launches_per_update": host / n_updates,
            "device_kernels_per_update": kernels / n_updates,
        }
        del algo, ts, buffer, bs, coll, trainer
    if "physics" in paths:
        from tianshou_tpu_torch.env.core import VectorDeviceEnv
        from tianshou_tpu_torch.env.mujoco import make

        for task, steps in chip_smoke.PHYS_PATHS:
            t0 = time.perf_counter()
            venv = VectorDeviceEnv(make(task), chip_smoke.PHYS_E, device="cuda")
            _, program, _ = rollout_program(venv, steps)
            for _ in range(2):  # warm-up (and where there is a graph, its capture)
                program()
            plain, traced, busy, kernels, host = _trace(program, torch)
            out[task.lower()] = {
                "seconds": time.perf_counter() - t0,
                "us_per_vector_step": plain / steps * 1e6, "env_steps_per_s": steps * venv.num_envs / plain,
                "device_busy_us_per_step": busy / steps, "idle_share": 1 - busy / 1e6 / plain,
                "idle_share_traced": 1 - busy / 1e6 / traced, "host_launches_per_step": host / steps,
                "device_kernels_per_step": kernels / steps,
            }
    return out


def compare(parent: str, pairs: int, paths: str, smi: str) -> None:
    """``pairs`` pairs of measuring processes, the parent tree and this one in turns (ABBA)."""
    trees = {"parent": os.path.abspath(parent), "change": ROOT}
    runs = []
    for i in range(pairs):
        for tree in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
            cmd = [sys.executable, os.path.abspath(__file__), "--measure", "--tree", trees[tree], "--paths", paths]
            t0 = time.perf_counter()
            done = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
            found = [ln for ln in done.stdout.splitlines() if ln.startswith("MEASURE ")]
            if done.returncode != 0 or not found:
                raise RuntimeError(f"measuring {tree} failed (rc {done.returncode}):\n{done.stdout[-3000:]}\n"
                                   f"{done.stderr[-3000:]}")
            runs.append({"tree": tree, "pair": i, "process_s": time.perf_counter() - t0,
                         **json.loads(found[-1][len("MEASURE "):])})
            print(f"pair {i} {tree} ({runs[-1]['process_s']:.0f} s): " + "; ".join(
                f"{path} " + ", ".join(f"{k} {v:.4g}" for k, v in m.items()) for path, m in runs[-1]["paths"].items()),
                flush=True)
    summary = {}
    for tree in ("parent", "change"):
        mine = [r["paths"] for r in runs if r["tree"] == tree]
        for path in sorted({p for r in mine for p in r}):
            for metric in sorted({k for r in mine if path in r for k in r[path]}):
                vals = [r[path][metric] for r in mine if path in r]
                summary.setdefault(path, {}).setdefault(metric, {})[tree] = {
                    "median": statistics.median(vals), "min": min(vals), "max": max(vals), "n": len(vals)}
    print(f"== {pairs} pairs in turns, parent tree {trees['parent']} against this tree [{smi}] ==")
    print("path metric: parent median (min-max) | this tree median (min-max)")
    for path, metrics in summary.items():
        for metric, by_tree in metrics.items():
            cells = [f"{by_tree[t]['median']:.6g} ({by_tree[t]['min']:.6g}-{by_tree[t]['max']:.6g})"
                     if t in by_tree else "-" for t in ("parent", "change")]
            print(f"  {path} {metric}: {cells[0]} | {cells[1]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"profile_pairs_{paths.replace(',', '_')}.json"), "w") as f:
        json.dump({"device": smi, "pairs": pairs, "runs": runs, "summary": summary}, f, indent=1)


def _traced_graph(fn, torch, gen, calls: int = 5) -> dict:
    """``fn`` (drawing from ``gen``) as a CUDA graph (eager warm-up, capture), then replayed ``calls``
    times between CUDA events (median device ms) and once traced: busy us, kernels and kernel classes."""
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    program = Graphed(fn, GraphPool("cuda"), (gen,), name="profiled")
    program(), program()
    times = []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        program()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    _, _, per_name, _, span = _trace_kernels(program, torch)
    busy = sum(sum(v) for v in per_name.values())
    return dict(ms=statistics.median(times), busy_us=busy, span_us=span,
                kernels=sum(len(v) for v in per_name.values()), classes=_kernel_classes(per_name))


def profile_trust_region(smi: str) -> None:
    """Where the time of an NPG and a TRPO rollout goes (``chip_smoke.build_trust_region`` at the
    examples' widths): the collect chunk and the update as replayed graphs, then the update without its
    conjugate-gradient iterations and, for TRPO, without its line search; then the MLP PPO megastep."""
    import torch

    cs = chip_smoke
    for kind in ("npg", "trpo"):
        variants = {"full": {}, "cg_iters 0": {"cg_iters": 0}}
        if kind == "trpo":
            variants["max_backtracks 0"] = {"max_backtracks": 0}
        print(f"== {kind}_halfcheetah: E={cs.TR_E}, T={cs.TR_T}, one update of {cs.TR_E * cs.TR_T} rows, "
              f"{cs.TR_CRITIC_ITERS} critic steps ==")
        print(f"device: {smi}")
        res = {}
        for name, attrs in variants.items():
            algo, ts, coll = cs.build_trust_region(torch, kind, cs.TR_E)
            for k, v in attrs.items():
                setattr(algo, k, v)
            gen = torch.Generator(device="cuda").manual_seed(0)
            cstate = coll.reset(gen)
            rollout = coll.rollout(ts, cstate, None, gen, cs.TR_T, keep_rollout=True).rollout
            if name == "full":
                collect = _traced_graph(lambda: coll.rollout(ts, cstate, None, gen, cs.TR_T, keep_rollout=True), torch,
                                        gen)
                print(f"collect chunk: {collect['ms']:.3f} ms device (median of 5 replays), busy "
                      f"{collect['busy_us'] / 1e3:.3f} ms, {collect['kernels']} kernels")
            res[name] = _traced_graph(lambda: algo.update_rollout(ts, rollout, gen, 1, cs.TR_BATCH)[1], torch, gen)
            r = res[name]
            print(f"update ({name}): {r['ms']:.3f} ms device (median of 5 replays), busy {r['busy_us'] / 1e3:.3f} ms "
                  f"over a span of {r['span_us'] / 1e3:.3f} ms, {r['kernels']} kernels")
            if name == "full":
                for cls, (n, us) in sorted(r["classes"].items(), key=lambda kv: -kv[1][1]):
                    print(f"  {cls}: {n} kernels, {us / 1e3:.3f} ms ({us / r['busy_us']:.3f} of busy)")
        full = res["full"]
        for name, r in res.items():
            if name != "full":
                print(f"{'conjugate gradient' if 'cg' in name else 'line search'} ({name} against full): "
                      f"{full['kernels'] - r['kernels']} kernels, {(full['ms'] - r['ms']):.3f} ms, share of the update "
                      f"{1 - r['ms'] / full['ms']:.3f} (busy {1 - r['busy_us'] / full['busy_us']:.3f})")

    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic

    torch.manual_seed(0)
    env = CartPole()
    algo = PPO(actor=DiscreteActor((64, 64), 2, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
               action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5),
               deterministic_eval=True)
    ts = algo.init("cuda")
    coll = DeviceCollector(VectorDeviceEnv(env, cs.MLP_E, device="cuda"), algo, None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cstate = coll.reset(gen)
    parts = {"collect": lambda: coll.rollout(ts, cstate, None, gen, cs.MLP_T, keep_rollout=True)}
    held = parts["collect"]()
    parts["update"] = lambda: algo.update_rollout(ts, held.rollout, gen, cs.MLP_REPEAT, cs.MLP_BATCH)[1]
    print(f"== ppo_mlp_cartpole: E={cs.MLP_E}, T={cs.MLP_T}, {cs.MLP_REPEAT} passes of batch {cs.MLP_BATCH}, the collect "
          f"and the update as graphs of their own ==")
    print(f"device: {smi}")
    for part, fn in parts.items():
        r = _traced_graph(fn, torch, gen)
        print(f"{part}: {r['ms']:.3f} ms device (median of 5 replays), busy {r['busy_us'] / 1e3:.3f} ms, "
              f"{r['kernels']} kernels")
        for cls, (n, us) in sorted(r["classes"].items(), key=lambda kv: -kv[1][1])[:4]:
            print(f"  {cls}: {n} kernels, {us / 1e3:.3f} ms ({us / r['busy_us']:.3f} of busy)")


def main() -> int:
    global chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--paths", default="dqn,rainbow,physics",
                    help="comma-separated: dqn, rainbow, physics, sumtree, ppo, offpolicy, trust_region, distributional, "
                         "offline")
    ap.add_argument("--compare", metavar="PARENT_TREE", help="measure this tree against PARENT_TREE in turns")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--measure", action="store_true", help="measure the paths once and print one MEASURE line")
    ap.add_argument("--tree", default=ROOT, help="the checkout whose chip_smoke and tianshou_tpu_torch to import")
    args = ap.parse_args()
    paths = set(args.paths.split(","))
    extra = {"sumtree", "ppo", "offpolicy", "trust_region", "distributional", "offline"}  # not in --compare
    if not paths <= {"dqn", "rainbow", "physics"} | extra:
        ap.error(f"unknown path in {args.paths!r}")
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as module

    chip_smoke = module
    import torch

    if not torch.cuda.is_available():
        print("torch_port_profile: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke._smi()
    if args.compare:
        compare(args.compare, args.pairs,
                ",".join(sorted(paths - extra)), smi)
        return 0
    if args.measure:
        print("MEASURE " + json.dumps({"device": smi, "paths": measure(paths)}), flush=True)
        return 0
    if "dqn" in paths:
        profile_path("dqn", args.chunks, smi)
    if "rainbow" in paths:
        buffer, state, gen = profile_path("rainbow", args.chunks, smi)
        profile_per_parts(buffer, state, gen, smi)
    if "sumtree" in paths:
        profile_sumtree(smi)
    if "physics" in paths:
        for task, steps in chip_smoke.PHYS_PATHS:
            profile_physics(task, steps, smi)
        profile_physics(*chip_smoke.PEN_PATH, smi, penalty=True)
        profile_physics("Humanoid", chip_smoke.HUM_T, smi)
        for task in chip_smoke.PHYS_TASKS:
            if task not in dict(chip_smoke.PHYS_PATHS):
                kernel_scaling(*rollout_state(task), smi)
    if "ppo" in paths:
        profile_ppo(smi)
    if "offpolicy" in paths:
        profile_offpolicy(smi)
    if "trust_region" in paths:
        profile_trust_region(smi)
    if "distributional" in paths:
        profile_distributional(smi)
    if "offline" in paths:
        profile_offline(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
