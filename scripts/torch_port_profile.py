"""Where the time of the PyTorch port's main paths goes, on one NVIDIA GPU.

    python3 scripts/torch_port_profile.py [--chunks 1] [--paths dqn,rainbow,physics,sumtree]

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
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402


def _device_events(prof) -> dict[str, list[float]]:
    """Device-side kernel times by name, less the user annotations that mirror CPU ops on the
    device timeline (e.g. "Optimizer.step#Adam.step"), which span kernels counted on their own."""
    import torch

    per_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            per_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return per_name


def profile_path(kind: str, chunks: int, smi: str):
    """Time and trace ``chunks`` update chunks of the pipeline of ``kind``; returns its buffer,
    buffer state and generator for the traces of the parts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    E, T, batch = chip_smoke.E, chip_smoke.T, chip_smoke.BATCH
    algo, ts, buffer, buf_state, coll = chip_smoke.build_pipeline(torch, kind)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def trainer(n: int, prefill: bool) -> OffPolicyTrainer:
        params = OffPolicyTrainerParams(
            max_epochs=1, epoch_num_steps=n * T * E, batch_size=batch,
            collection_step_num_env_steps=T, update_per_step=0.1,
            start_steps=T * E if prefill else 0, verbose=False,
        )
        return OffPolicyTrainer(algo, coll, None, buffer, params)

    res = trainer(1, prefill=True).run(ts, buf_state, gen)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer(chunks, prefill=False).run(res.train_state, res.buf_state, gen)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_timing = dict(res.timing)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = trainer(chunks, prefill=False).run(res.train_state, res.buf_state, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_name = _device_events(prof)
    busy_us = sum(sum(v) for v in per_name.values())
    launches = sum(len(v) for v in per_name.values())
    updates = res.gradient_step
    print(f"== {kind} path ==")
    print(f"device: {smi}")
    print(f"profiled {chunks} chunk(s): {chunks * T * E} env steps, {updates} updates")
    print(f"wall ms without the profiler {plain_wall * 1e3:.1f} (collect {plain_timing['collect'] * 1e3:.1f}, "
          f"update {plain_timing['update'] * 1e3:.1f} = {plain_timing['update'] / max(updates, 1) * 1e3:.3f} per update)")
    print(f"wall ms under the profiler {wall * 1e3:.1f} (collect {res.timing['collect'] * 1e3:.1f}, "
          f"update {res.timing['update'] * 1e3:.1f})")
    print(f"device busy ms {busy_us / 1e3:.1f}, idle share {1 - busy_us / 1e3 / (plain_wall * 1e3):.3f} "
          f"against the wall time without the profiler ({1 - busy_us / 1e3 / (wall * 1e3):.3f} under it), "
          f"kernel launches {launches} ({launches / max(updates, 1):.1f} per update incl. collect)")
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = venv.reset(gen)

    def run(state, n):
        for _ in range(n):
            state = venv.step(state, venv.action_space.sample(E, gen, venv.device), gen).state
        torch.cuda.synchronize()
        return state

    state = run(state, 4)  # warm-up: library load, local memory, allocator
    t0 = time.perf_counter()
    state = run(state, steps)
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = run(state, steps)
        wall = time.perf_counter() - t0
    per_name = _device_events(prof)
    busy_us = sum(sum(v) for v in per_name.values())
    launches = sum(len(v) for v in per_name.values())
    fused = {k: v for k, v in per_name.items() if "fused_step_kernel" in k}
    fused_us = sum(sum(v) for v in fused.values())
    print(f"== {task} physics path ==")
    print(f"device: {smi}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--paths", default="dqn,rainbow,physics", help="comma-separated: dqn, rainbow, physics, sumtree")
    args = ap.parse_args()
    paths = set(args.paths.split(","))
    if not paths <= {"dqn", "rainbow", "physics", "sumtree"}:
        ap.error(f"unknown path in {args.paths!r}")

    import torch

    if not torch.cuda.is_available():
        print("torch_port_profile: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke._smi()
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
