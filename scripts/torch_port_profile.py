"""Where the time of the PyTorch port's main paths goes, on one NVIDIA GPU.

    python3 scripts/torch_port_profile.py [--chunks 1] [--paths dqn,rainbow,physics,sumtree]
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
envs, random actions: ``bench.py:bench_physics_step``) it times 64 (Ant: 16)
vector steps without the profiler and traces as many more: wall time per
vector step, device busy time, idle share, launches per step, and how the
device time of one ``venv.step`` splits between the fused step kernel and the
small kernels around it (action sampling, clip, reward, observation,
termination). Then the kernel alone on the path's last states (device time
from a replayed CUDA graph): against the number of envs (32 to 33792), with
the contact solver's iterations at 0 and at the task's count, and against
what the launch exposes: lanes per env (``TEAM``, one library each) and envs
per block. The same sweep then runs for the four tasks that have no path here,
on states 32 random-action steps from reset.

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


def profile_physics(task: str, steps: int, smi: str) -> None:
    """Time and trace ``steps`` vector steps of the physics path of ``task``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make

    E = chip_smoke.PHYS_E
    venv = VectorDeviceEnv(make(task), E, device="cuda")
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
    print(f"== {task} physics path ({'one CUDA graph of the rollout' if graphed else 'eager'}) ==")
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


def main() -> int:
    global chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--paths", default="dqn,rainbow,physics", help="comma-separated: dqn, rainbow, physics, sumtree")
    ap.add_argument("--compare", metavar="PARENT_TREE", help="measure this tree against PARENT_TREE in turns")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--measure", action="store_true", help="measure the paths once and print one MEASURE line")
    ap.add_argument("--tree", default=ROOT, help="the checkout whose chip_smoke and tianshou_tpu_torch to import")
    args = ap.parse_args()
    paths = set(args.paths.split(","))
    if not paths <= {"dqn", "rainbow", "physics", "sumtree"}:
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
        compare(args.compare, args.pairs, ",".join(sorted(paths - {"sumtree"})), smi)
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
        for task in chip_smoke.PHYS_TASKS:
            if task not in dict(chip_smoke.PHYS_PATHS):
                kernel_scaling(*rollout_state(task), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
