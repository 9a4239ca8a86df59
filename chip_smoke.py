#!/usr/bin/env python3
"""Drive the PyTorch port (``tianshou_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. Require CUDA; print the card's name and power limit and the TF32 settings.
2. Build every hand-written kernel from the sources in the checkout.
3. Kernel phase: hold each kernel bit-exact against its plain PyTorch
   version on the card, and time the kernel, the plain version and one
   PyTorch library call with CUDA events: device time per call from a
   replayed CUDA graph of 20 calls, and eager time of single calls, each the
   median of 60 runs after a warm-up. The gather is timed beside an empty
   launch of the same shape. The sum tree has two kernels, the descent
   (``prefix_sum_idx``) and the update (``tree_update``): both are held
   bit-exact on whole trees (builds from 131072 and 300000 indices with
   duplicates and dropped ones, the training path's 32 and 256 leaves, the
   one-block edge at 1024/1025 entries; the TD3 Ant + PER path's tree of
   1000000 leaves with 256 values and 256 and 32 written leaves) and timed at B = 32 and 4096 values
   and k = 32 and 256 leaves.
4. Graph phase: the trainer's programs as CUDA graphs against the eager
   loop, for the DQN and the Rainbow pipelines of phases 5 and 6 at full
   width (``graph_phase``): from one prefilled state and one generator state,
   three collect chunks and three bursts of 8 updates through the graphs
   against the same run eagerly, each on a deep copy. Sampled indices, rings, collect state
   and output and the sum tree bit-identical; losses, TD errors and
   parameters within ``GRAPH_ATOL`` (expected exact, cuDNN held to
   deterministic algorithms); the same kernel launches. Then the pipeline's
   Adam as the trainer builds it on the card (``capturable=True``, step and
   bias corrections on the device), ``ADAM_STEPS`` steps as one replayed
   graph, against the same factory's Adam on CPU copies of the trained
   parameters, with the same gradients (``adam_check``), held to the JAX
   one-update test's tolerance: ``ADAM_ATOL``, and ``ADAM_SHARE`` of the
   values within ``ADAM_CLOSE``.
5. DQN path: the DQN-on-pixels pipeline of ``bench.py``
   (``_build_atari_pipeline`` / ``bench_atari_cnn``) at its widths:
   ``FrameStack(SyntheticAtari(), 4)`` over 256 envs, a uint8 replay of
   256*512 frames per ring with ``stack_num=4`` and ``save_only_last_obs``,
   and ``DQN(DQNet(6))`` with n=3, gamma 0.99, target sync every 500 steps,
   eps 0.05 and Adam at lr 1e-4, trained by ``OffPolicyTrainer`` (its collect
   chunk and update burst are CUDA graphs) for a random prefill chunk plus
   three chunks of T=16 steps with update_per_step 0.1 and batch 32 (410
   updates a chunk), the first of each program's chunks its eager warm-up and
   the second its capture, then a second ``run`` of three chunks that only
   replays, which is timed. Launch counters are zeroed just before and read
   just after both runs; the gather kernel must run exactly twice per update.
   The same DQN path then runs with ``fused_megastep=True``: one graph per chunk.
6. Rainbow path: the same pixel pipeline with the two parts of the
   ``examples/atari/atari_rainbow.py`` configuration exchanged: a
   prioritized replay (``PrioritizedVectorReplayBuffer``, alpha 0.6, beta
   0.4, a sum tree of 131072 leaves) and ``RainbowDQN`` over the noisy
   dueling ``RainbowAtariNet(6, 51 atoms)`` with Adam at lr 6.25e-5, at the
   same depth. Counters are zeroed and read around it in the same way: the
   descent kernel must run once and the gather kernel twice per update, the
   update kernel once per update (the priority writeback) and once per
   collect step (the new rows' max priority), prefill included; the final
   tree must hold ``node = left + right`` exactly at every internal node,
   with zero leaves at never-written slots.

   Each pixel path also has a test collector (10 envs of the same frames, eps_inference 0.005 as
   ``examples/atari/atari_dqn.py:58`` sets it, 10 episodes, chunks of 128 steps, the test chunk a
   CUDA graph too): one test phase at the end of each ``run``; each must return 10 episodes with
   finite returns, and its wall time, chunks and capture time are printed on a line of their own.
   The printed env-steps/s and ms per update count collect and update time only, as before.
   The DQN graph phase also holds the test chunk as a graph against the same chunk run eagerly,
   from one generator state and one reset: the active mask, the episode count and the emitted
   returns and lengths bit-identical.
7. CartPole paths (``tests/test_dqn.py:17-48``, which mirrors upstream ``test/discrete/test_dqn.py``):
   ``DQN(Net((64, 64), 2))`` on 10 train and 10 test envs of ``CartPole()``, Adam lr 1e-3, gamma
   0.97, n-step 3, target sync every 320 steps, eps 0.3 annealed by ``train_fn`` to 0.1 over 30,000
   steps, batch 64, T = 10, update_per_step 0.1, a prefill of 1,000 steps, up to 15 epochs of 5,000
   steps with ``stop_fn`` at reward 195, seed 0, once over ``VectorReplayBuffer(20000, 10)`` and
   once over ``PrioritizedVectorReplayBuffer(20000, 10, alpha 0.6, beta 0.4)``. Each must reach
   ``best_reward >= 195``; the train collector's ``on_episode_done_hook`` must fire once per
   collect chunk under the CUDA graphs; kernels: no gather, and with PER the descent once per update
   and the tree update once per update and once per collect step.
8. Determinism phase: the uniform CartPole path twice for 2 epochs from seed 0 under
   ``TraceLoggerContext`` (cuDNN held to deterministic algorithms; no other setting): the two traces,
   parameter hashes included, equal line for line (``TraceDeterminismTest``).
9. Physics kernel phase: for each of the six MuJoCo tasks at E = 2048, 32 and 10 (the
   off-policy paths' train and test envs; HalfCheetah also at E = 6 and 2053) hold the fused
   step kernel against its plain version
   (``dynamics.step``): near-home states, every env within ``q`` rtol = atol = 2e-4 and ``qd``
   rtol = atol = 5e-3; states from the kernel's own random-action rollout at steps 16, 32 and
   64, at least 99.5% of envs within the same tolerances (a contact that sits on its activation
   threshold may differ) and every output finite, and at step 32 the first 32, 16 and 10 rows
   stepped alone bit-identical to the kernel's rows at E = 2048 (E = 16, the trust-region and PPO
   example paths' train envs, also near home); for Ant also rotation vectors
   beyond pi, so that the re-chart runs. Times: the kernel's device time from a replayed CUDA graph and its
   eager time, at E = 2048 and, from the graph, at E = 32 and 8448 (is it bound by latency or by
   throughput); the plain version's eager time (its Cholesky calls are not captured in a graph);
   the bound by float32 operations counted for this run's active contact and limit rows.
10. Physics paths (``bench.py:bench_physics_step``): ``VectorDeviceEnv(HalfCheetah(), 2048)``,
   reset, 64 vector steps with actions from ``action_space.sample`` as one program, the
   counterpart of the scan, called three times (eager warm-up, capture and replay of one CUDA
   graph, replay); then Ant, 16 steps. One kernel launch per step exactly (and none of the other
   kernels), every state, observation and reward finite, Ant's termination rule.

11. On-policy graph phase: ``OnPolicyTrainer``'s collect chunk and ``update_rollout`` as CUDA graphs
   against the same calls run eagerly on deep copies (``onpolicy_graph_phase``): PPO on
   ``NormObs(HalfCheetah())`` at 64 envs with ``recompute_advantage``, the linear rate schedule and a
   ``target_kl`` that trips the KL guard mid-rollout; rollouts, normalization statistics and
   permutations bit-identical, weights, Adam state and rate within ``GRAPH_ATOL``, the step counters
   those of the untripped minibatches.
12. PPO physics paths (``bench.py:bench_mujoco_ppo``): ``NormObs(HalfCheetah())``, E = 2048, T = 32,
   4 passes of batch 16,384, ``ContinuousActorProbabilistic((64, 64), 6)`` and
   ``ContinuousCritic((64, 64))``, Adam 3e-4 with ``max_grad_norm`` 0.5, return standardization and
   the value clip: one program (collect with ``keep_rollout`` and then ``update_rollout``) as one
   CUDA graph, eager warm-up, capture and 4 timed replays; exactly T ``physics_fused`` launches per
   megastep and no other kernel, every weight and statistic finite, each env's count advanced by T
   per megastep; the collect and the update then timed apart as graphs of their own. Then Ant at
   T = 16 (the depth cut as the Ant physics path cuts it).
13. PPO CartPole path (``tests/test_onpolicy.py:17-53``) through ``OnPolicyTrainer`` and its
   collect, update and test graphs; it must reach reward 195 within 20 epochs.
14. The MuJoCo example path (``examples/mujoco/mujoco_ppo.py`` defaults on HalfCheetah: 16 envs,
   rollouts of 128, 10 passes of batch 64, the linear rate decay, ``target_kl`` 0.015, the PPO init,
   ``NormObs``, 10 test episodes), cut to 1 epoch of 16,384 steps: finite test returns, the pooled
   train statistics at every handoff to the test envs, the rate after the run the schedule's.

15. Continuous graph phase: ``OffPolicyTrainer``'s collect chunk and update burst as CUDA graphs against
   the eager loop for TD3, SAC (``alpha="auto"``) and REDQ on HalfCheetah at the examples' widths (32
   envs, 256x256 nets, batch 256): three collect chunks of T = 4 and three bursts of 8 updates, so that
   TD3 crosses both sides of its delay and REDQ its step 20; weights, targets, ``log_alpha``, every Adam
   state, rings and collect state bit-identical; the actor's Adam count the number of applied steps. For
   SAC, the alpha and actor optimizers on the card against the CPU (``adam_check``).
16. Continuous off-policy paths (``OFF_PATHS``): ``examples/mujoco/mujoco_sac.py``'s defaults on
   HalfCheetah, ``mujoco_td3.py``'s on Ant over prioritized replay (alpha 0.6, beta 0.4) and
   ``mujoco_redq.py``'s on HalfCheetah (32 envs, T 4, 128 updates per megastep of batch 256, a 1 M-row
   replay, 256x256 nets, the random prefill, ``fused_megastep``, 10 test episodes), each cut to one
   epoch of 1,250 steps (and TD3's prefill from 25,000 steps to SAC's 10,000): exactly one ``physics_fused`` launch per vector step, prefill
   and test included; with PER one descent per update, one tree update per update and per collect
   step, and an exactly consistent tree; then the megastep graph replayed alone for its wall and device
   time.
17. Pendulum paths (``tests/test_continuous.py:22-86``): SAC, TD3 and DDPG with 8 + 10 envs, a 50,000-row
   replay, batch 128, T 8, 0.5 updates per env step, a 2,000-step prefill of the policy, at most 12
   epochs of 4,000 steps; each must reach -250.

18. Trust-region and gSDE graph phase (``trust_region_graph_phase``): NPG's and TRPO's ``update_rollout``
   (the conjugate gradient by double backward, TRPO's line search by select) as the trainer's graph at
   the examples' widths against the eager call, three rollouts: weights, the critic's Adam state and
   count, and every stat, ``step_frac`` and ``accepted`` included, bit-identical (max |diff| 0). Then a
   PPO+gSDE collect chunk as a graph against the eager chunk, three chunks of 400 steps across
   HalfCheetah's episode end: rollouts, carried noise and counts bit-identical. cuDNN deterministic.
19. NPG and TRPO physics paths (``examples/mujoco/mujoco_{npg,trpo}.py``'s defaults on
   ``NormObs(HalfCheetah())``: 16 envs, T 64, one update per rollout of 1,024 rows, 20 critic steps, 10
   test episodes), cut to 1 epoch of 100,000 steps: exactly one ``physics_fused`` launch per vector
   step, train and test; every stat finite; the first update's relative conjugate-gradient residual;
   TRPO's step fractions and the share of updates accepted; the update graph replayed alone.
20. The gSDE example path (``mujoco_ppo.py --sde``: ``sigma_init`` -2.0, the example path's other
   defaults) cut to 1 epoch of 16,384 steps: one ``physics_fused`` launch per vector step; after every collect chunk
   each env's carried count the steps since the chunk's start or its last episode end; an eager check
   that the noise stays bit-unchanged between resamples.
21. TRPO CartPole (``tests/test_trust_region.py:26-55``): 16 + 10 envs, T 128, batch 1,024, at most 15
   epochs of 10,000 steps; it must reach 195. No kernel.
22. The MLP PPO path (``bench.py:312-350`` ``bench_mlp_ppo``): PPO on CartPole at E = 4,096, T 128, 4
   passes of batch 16,384, one graph per megastep, 8 timed replays: env-steps/s and ms per megastep.
   No kernel.

23. The penalty branch of the physics kernel (``contact_model="penalty"``, ``-DTT_PENALTY=1``, its own library
   per signature), inside phase 9 for each of the six tasks (``penalty_checks``): near home at E = 2048, 32 and
   10, every env inside ``q`` 2e-4 / ``qd`` 5e-3 of the plain version; states pushed into the floor and past
   joint limits at E = 2048 (the springs must act), at least 99.5% of envs inside; timed there beside the bound
   of the penalty model's operations. The numbers go into the record's ``penalty`` entry.
24. ``physics_penalty_halfcheetah`` (``bench.py:bench_physics_step``'s twin under the penalty model, set on the
   env's model after construction): E = 2048, T = 64, one graph; exactly one ``physics_fused`` launch per step.
25. ``humanoid_physics``: ``VectorDeviceEnv(Humanoid(), 2048)`` on the plain route (``dynamics.step`` with its
   geom-pair rows; neither package has a kernel for them), T = ``HUM_T`` (cut from 64), one graph, no kernel
   launch, finite states, and a graph of fixed-action steps bit-identical to the eager loop.
26. ``sac_humanoid`` (``OFF_PATHS``): ``mujoco_sac.py --task Humanoid``'s defaults with the prefill and the epoch
   cut (``HUM_SAC_*``); no kernel launch; the 10 test episodes run eagerly after the epoch.
27. ``inverted_pendulum_sac`` (``tests/test_mujoco_table.py:41-53``): SAC on ``InvertedPendulum``; it must
   reach 1,000 within 12 epochs. No kernel.

28. Distributional graph phase: ``graph_phase`` (phase 4) for QRDQN, IQN, FQF and discrete SAC on the pixel
   pipeline of phase 29 (``DIST_KINDS``): collect chunks and update bursts as graphs against the eager loop
   from one generator state, bit-identical (IQN's fractions and discrete SAC's actions come from the graph's
   registered generator), every optimizer's state (FQF's Adam and RMSprop, discrete SAC's four Adams) too.
29. Distributional pixel paths: ``main_path`` (phase 5) with the algorithm and net of each of
   ``examples/atari/atari_{qrdqn,iqn,fqf,sac}.py`` at bench.py's widths and ``DIST_CHUNKS`` (2) chunks a run
   of ``DIST_T`` (4) env steps each, bursts of 102 updates (``build_pipeline``): QRDQN over ``QRDQNet(6, 200)``
   at lr 5e-5, IQN over ``ImplicitQuantileAtariNet(6)``
   with 32/8/8 fractions at 5e-5, FQF over the same net with 32 fractions and ``ent_coef`` 10 at 5e-5,
   discrete SAC with ``DQNet`` actor and twin critics at 1e-4 and automatic alpha; n = 3, target sync every
   500 steps (polyak 0.005 for SAC). Exactly two ``gather_rows`` launches per update; after the checks one
   replayed update burst is traced (``torch.profiler``): kernels per update, device ms per update, the idle
   share of the burst's span.
30. Time to score of the family on the card (``tests/test_distributional.py:89-107``): FQF on CartPole to 195
   and BDQN on ``ContinuousToDiscrete(Pendulum(), 25)`` to -250, the reference tests' settings and budgets
   (``DIST_SCORE``), each stopping at its threshold and raising below it. No kernel.

31. Host venvs (``host_ring_identity``): one chunk of ``HD_T`` steps of ``HD_E`` envs of ``ScriptedAtari`` (210x160x3
   uint8 frames, lives, FIRE; a numpy game defined here, since no ALE is installed) under ``wrap_deepmind``, at eps 0
   from one train state, collected by ``HostCollector`` over ``DummyVectorEnv``, ``SubprocVectorEnv`` and
   ``ShmemVectorEnv``: rings bit-identical. ``PipelinedHostCollector`` over 4 Subproc CartPole twins
   (``NumpyCartPole``, Gymnasium's CartPole-v1 in numpy): ``tests/test_host_env.py:175-205``'s properties, and at
   eps 0 the sequential collector's rings bit for bit.
32. ``host_dqn_pixels`` (``examples/atari/_runner.py:_run_offpolicy_host``): DQN over ``DQNet(4)`` through
   ``HostOffPolicyTrainer`` and a ``HostCollector`` of 16 envs, a 100,000-frame uint8 ring, the random prefill and the
   epoch cut (``HD_*``), a test phase of 10 episodes; once sequentially and once with ``overlap_updates``. Exactly 2
   ``gather_rows`` per update; env-steps/s and the host/device split of a vector step.
33. ``host_ppo_cartpole``: PPO at ``tests/test_onpolicy.py:17-53``'s settings through ``HostOnPolicyTrainer`` over
   ``VectorEnvNormObs(SubprocVectorEnv(NumpyCartPole))``, the test venv reading the train venv's statistics; 195.
34. ``recurrent_dqn_pomdp`` (``tests/test_recurrent.py:62-92``): the collect chunk (the LSTM carry under the graph)
   and the update burst as graphs against eager, bit-identical; then RecurrentDQN to 100, 2 ``gather_rows`` of 256 rows
   of 8 B per update.
35. ``her_ddpg_goal_reach_n1`` / ``_n3`` (``tests/test_her.py:110-145``): the same graph check with the HER buffer
   (its future-goal draws from the graph's generator), then HER-DDPG from seeds 0, 1 and 2; the median best test
   reward within 8 epochs must reach -20.
36. ``cached_buffer``: ``tests/test_cached_buffer.py``'s episodes and random ones on the card against the CPU; rings,
   caches and stacked gets bit-identical (2 ``gather_rows`` per stacked get).
37. Finite envs: a ``FiniteSubprocVectorEnv`` collect through ``HostCollector`` on the card, the CPU's step counts.
   The kernel phase (3) also holds ``gather_rows`` at the recurrent path's 256 rows of 8 bytes.

38. The offline ring (``fill_offline_ring``): ``bench.py``'s uint8 ring (256 x 512 frames, stack 4, newest frame
   only) filled once by the DQN pipeline's collector from its seeded untrained weights at eps 0.2: 512 steps of
   256 envs as collect chunks of T = 16 (the trainer's graph), no updates; its line gives the eps and the fill time.
39. The offline pixel paths (``offline_pixel_path``, ``examples/offline/atari_{bcq,cql,crr}.py``'s defaults,
   ``build_offline``): ``DiscreteBCQ(DQNet(6), DQNet(6))``, ``DiscreteCQL(QRDQNet(6, 200))`` and
   ``DiscreteCRR(DQNet(6), DQNet(6))``, each from its own copy of the ring. First ``offline_graph_check``:
   ``OfflineTrainer``'s update burst as a graph against ``algo.update`` eager, 3 x 8 updates from one state and one
   generator state, sampled indices, stats, weights, targets and optimizer state bit-identical. Then one epoch of
   ``OFF_UPDATES`` = 1,000 updates of batch 32 (cut from 100 epochs of 10,000) in bursts of
   ``OfflineTrainer.BURST`` = 100 (one graph, 9 replays) and the pixel test phase; counters zeroed just before and read just after the run:
   ``gather_rows`` exactly ``OFFLINE_GATHERS`` (2) per update and nothing else; then one replayed burst traced
   (``_trace_burst``: kernels and device ms per update, ``gather_rows``' share of busy, the idle share).
40. ``offline_cartpole``: the CartPole dataset of ``tests/conftest.py:66-113`` (``expert_dataset``: DQN to 195 through
   the graphed trainer, then 2,000 steps of 10 envs at eps 0.2), then BC, discrete BCQ, CQL and CRR at
   ``tests/test_offline.py:67-112``'s settings (``build_offline_classic``), each held graph against eager first,
   through ``OfflineTrainer`` (up to 8 epochs of 500 updates, 10 test episodes); each must reach 150. No kernel.
41. ``offline_pendulum``: the Pendulum dataset (SAC to -250, then 2,500 steps of 8 envs), then BC, TD3+BC, BCQ and CQL
   at ``tests/test_offline.py:116-161``'s settings the same way; BC and BCQ must reach -800; TD3+BC and CQL, whose
   -800 is a draw of the seed in both packages, train from each seed of ``OFF_SEEDS`` (stopping at -800) and the
   median of their best rewards must reach the gate the JAX package's spread supports (-1,000 and -1,150). No
   kernel.
42. ``gail_pendulum`` (``tests/test_modelbased.py:30``): GAIL from the Pendulum dataset's rows; its ``update_rollout``
   graph against eager (``rollout_graph_check``), then ``OnPolicyTrainer`` to -1,100 within 15 epochs.
43. ``icm_dqn_cartpole`` / ``icm_ppo_cartpole`` (``:67``, ``:99``): the ICM wrappers over DQN and PPO, their update
   programs against eager, then to 195.
44. ``psrl_nchain`` (``:127``): PSRL on ``NChain(5, 0.2)``, the posterior update graph (counts, Dirichlet and normal
   draws, 200 value-iteration sweeps) against eager, then to 340. The phases 38-44 print their total time.

45. ``hl_sac_halfcheetah``: ``examples/mujoco/mujoco_sac_hl.py`` through the port's ``SACExperimentBuilder`` (16 + 10
   envs, a 1 M-row replay, batch 256, one update per env step, 256x256 nets, ``SACParams(actor_lr=1e-3, critic_lr=1e-3,
   alpha=0.2, tau=0.005)``), the random prefill cut from 10,000 to ``HL_SAC_PREFILL`` steps and the epoch from 20,000 to
   ``HL_SAC_EPOCH``: exactly one ``physics_fused`` launch per vector step (prefill, training, test) and no other kernel;
   the trainer's three programs as graphs; the builder's algorithm in the graph check of phase 34; one replayed burst
   traced (kernels and device ms per update).
46. ``hl_ppo_halfcheetah``: ``examples/mujoco/mujoco_ppo_hl.py`` through ``PPOExperimentBuilder`` (64 + 10 envs, rollouts
   of 2,048 steps per env, 10 passes of batch 64, ``PPOParams(lr=3e-4, eps_clip=0.2, gae_lambda=0.95,
   advantage_normalization=True, ent_coef=0.0)``), the epoch cut from 20,000 steps to one rollout: one ``physics_fused``
   launch per vector step, train and test; the gradient-step count; minibatch steps traced per gradient step.
47. ``hl_dqn_cartpole`` (``tests/test_highlevel.py:34-55``, nothing cut): 195 with persistence on, ``best`` and
   ``experiment.pkl`` written, ``Experiment.from_directory`` re-runs, ``best`` restores bit for bit. No kernel.
48. ``hl_dqn_cartpole_per`` (``tests/test_highlevel.py:270-278``): PER through ``with_buffer_factory``; one descent per
   update, one tree update per update and per collect step, the final tree checked by ``_check_tree``.
49. ``marl_tictactoe`` (``examples/marl/tictactoe_selfplay.py``'s settings, ``MARL_*``): DQN self-play through
   ``HostOffPolicyTrainer``; agent 0 must win at least 0.7 of 100 games against ``MARLRandomPolicy``; the multi-agent
   update as a graph against eager, bit for bit (``offline_graph_check``), its replay traced; a run through
   ``MARLExperimentBuilder``. No kernel.
50. ``classic_envs``: ``CLASSIC_STEPS`` vector steps of Acrobot, MountainCar and MountainCarContinuous at E = 2,048 as
   one graph against eager, bit for bit; ``examples/box2d/acrobot_dualdqn.py``'s setup for one epoch cut from 10,000
   steps to 2,000. No kernel. The phases 45-50 print their total time.

51. ``dp_dqn_pixels``: ``parallel/mesh.py:make_dp_offpolicy_train_step`` at world size 1 on a one-rank NCCL group over
   the DQN pixel pipeline of phase 5 at full width: ``DP_CHUNKS`` chunks of ``DP_T`` env steps (102 updates each) held
   bit-identical, every tensor of the train state, rings, collect state and stats, to ``OffPolicyTrainer.megastep``
   from a copy of the same state and generator; exactly 2 ``gather_rows`` per update; the eager wall per chunk beside
   the program's.
52. ``dp_ppo_halfcheetah``: ``make_dp_train_step`` at world size 1 over ``bench_mujoco_ppo``'s PPO (HalfCheetah,
   E = 2,048, T = 32, 4 passes of batch 16,384): ``DP_PPO_CALLS`` rollouts with their updates bit-identical to
   ``OnPolicyTrainer``'s two programs; one ``physics_fused`` launch per vector step; the walls side by side. The card
   runs the mesh at world size 1 only: NCCL puts no two ranks on one GPU (the multi-rank runs are CPU tests).
53. ``seeded_eval``: ``evaluation/launcher.py``'s ``run_seeded_experiments`` over seeds 0 and 1 of phase 48's builder
   (its launch counts as phase 48 checks them), then ``PoolExpLauncher(max_workers=2)`` under ``spawn`` on the card
   with the same seeds (best rewards equal) and an experiment made to fail (reported, the rest run), then
   ``eval_results``.
54. ``dp_trpo_halfcheetah``: ``make_dp_train_step`` at world size 1 over TRPO at the trust-region path's configuration
   (``TR_E`` envs, T = ``TR_T``, one minibatch of the rollout): ``DP_TR_CALLS`` rollouts with their updates
   bit-identical to ``OnPolicyTrainer``'s two programs; one ``physics_fused`` launch per vector step.
55. ``dp_sac_halfcheetah``: ``make_dp_offpolicy_train_step`` at world size 1 over SAC at the off-policy path's widths
   (``OFF_E`` envs, batch 256, 256x256): ``DP_SAC_CHUNKS`` chunks bit-identical to ``OffPolicyTrainer.megastep``, so the
   per-row noise drawn through the global-draw rule is the one-process draw; one ``physics_fused`` launch per vector
   step. The phases 51-55 print their total time.

56. ``examples``: port example scripts through their own ``main`` on the card (``EX_SCRIPTS``, an ``ExRun``
   each), at their defaults but for a depth cut (their options, else ``train``'s keywords, a helper of the module
   bound to smaller sizes, or the trainers' parameters set at construction): ``examples_torch/atari/atari_rainbow.py``
   on the catch game (a prioritized replay; ``EX_RAINBOW_PREFILL`` prefill steps and one epoch of
   ``EX_RAINBOW_EPOCH``), ``examples_torch/mujoco/mujoco_sac.py`` on HalfCheetah (``EX_SAC_PREFILL`` and
   ``EX_SAC_EPOCH``), and ``examples_torch/vizdoom/vizdoom_c51.py`` and ``vizdoom_ppo.py`` on SyntheticDoom's 40x60
   frames (``EX_DOOM_*``); then one script per runner route that those four do not drive: ``atari_sac.py`` (uniform
   pixel replay) and ``atari_ppo.py`` (``atari/_runner.py:run_onpolicy``), ``mujoco_trpo.py``
   (``mujoco/_runner.py:run_onpolicy``) and ``mujoco_td3.py`` (``run_offpolicy``), ``mujoco_ppo_hl.py`` (the
   Experiment API, its update as step graphs), ``ddpg_her_goalreach.py`` (the HER ring), ``discrete_cql_cartpole.py``
   (``offline/_gather.py``, then ``OfflineTrainer``), ``dqn_cartpole.py --logdir`` (the TensorBoard logger), and
   ``tictactoe_selfplay.py``, ``psrl.py``, ``irl_gail.py`` and ``acrobot_dualdqn.py`` (their own trainers).
   Counters zeroed and read around each ``main``: ``gather_rows`` 2, ``prefix_sum_idx`` 1 and ``tree_update`` 1 per
   update and ``tree_update`` 1 per collect step (Rainbow; the final tree through ``_check_tree``),
   ``physics_fused`` 1 per vector step (the MuJoCo scripts, prefill and test included), ``gather_rows`` 2 per update
   and nothing else (ViZDoom C51, then one gather on its ring held against ``src[idx]`` and ``SyntheticDoom._obs`` on
   the card against the CPU; Atari SAC), no kernel (every other script); each run ends with a finite test phase per
   trainer and finite weights on the card; each script's summary line with its wall and launches beside the card's
   name and power limit. The kernel phase (3) also holds and times ``gather_rows`` at the ViZDoom ring's 256 rows of
   2,400 bytes.

57. ``update_burst_pixels`` (``bench.py:186-232`` ``bench_atari_update_burst``; runs after phase 5's paths): the pixel
   pipeline of phase 5 at its widths, prefilled by ``UB_PREFILL`` collect steps at eps 0.05, then
   ``OffPolicyTrainer.update_burst`` of ``UB_UPDATES`` DQN updates of batch ``UB_BATCH`` as one CUDA graph (eager
   warm-up, capture, ``UB_ITERS`` timed replays) against the same updates run eagerly from one state and generator
   state: sampled indices bit-identical, losses, weights, target and Adam state within ``GRAPH_ATOL``; exactly 2
   ``gather_rows`` per update, each of 4 x ``UB_BATCH`` rows of 7,056 B, and one such gather bit-exact against
   ``src[idx]`` and timed beside it and its byte bound; grad steps/s, device ms per grad step, samples/s, the traced
   kernels per update, and the CNN's achieved TFLOP/s by ``bench.py``'s count beside the dense bf16 peak of the H100
   SXM data sheet.
58. ``ppo_halfcheetah_16k`` (``bench.py:359-362`` ``mujoco_ppo_16k``; runs after phase 12's paths): ``ppo_path`` at
   E = 16,384, T = 16, 4 passes of batch 65,536 and 2 timed replays, nothing cut, with phase 12's checks and one
   graph for the whole update (16 gradient steps, under ``OnPolicyTrainer.STEP_GRAPHS_ABOVE``); then
   ``physics_at_scale``: one vector step at E = 16,384 against the plain version (near home every env inside ``q``
   2e-4 / ``qd`` 5e-3; on the path's own state at least 99.5%), and the kernel's time there beside its first 2,048
   rows' and its operations bound.

59. ``seed_vmap_sac_halfcheetah`` (``examples_torch/benchmark/seed_vmap.py``, the seed-stacked multi-seed trainer;
   runs after phase 56): ``run_multiseed("sac", "HalfCheetah", SV_SEEDS)`` at its widths (32 envs a seed, 256x256
   nets, batch 256, T 4, one update per env step, a 1 M-row ring a seed, the 1,000-step test of 10 envs a seed), the
   prefill cut from 10,000 steps a seed to ``SV_PREFILL`` and the epochs to one of ``SV_EPOCH``; then the one-seed
   run of ``SV_SEEDS[1]`` at the same depth. Exactly one ``physics_fused`` launch per vector step over 96 train rows
   or 30 test rows and nothing else; the megastep one program, one graph replay per megastep after its warm-up;
   lane 1's train state and curve bit-equal to the one-seed run's; each run's megastep replayed alone; the kernel
   over the stacked 96 rows against three launches over 32, rows bit-equal, timed as phase 3 times it.
60. ``benchmark_throughput``: ``throughput.py``'s sweep (PPO CartPole at E = 64-4,096) through its ``main``, the timed
   megasteps cut from 10 to ``BT_ITERS``. No kernel.
61. ``benchmark_offpolicy``: ``offpolicy_throughput.py`` through its ``main`` (DQN CartPole at E = 1,024, separate
   programs, then the fused megastep), the timed run cut from 40 chunks to ``BO_CHUNKS``; each mode's gradient steps
   counted. No kernel.
62. ``benchmark_host``: ``host_throughput.py``'s ``run`` over ``SubprocVectorEnv`` of its ``SleepyCartPole`` around
   ``NumpyCartPole`` (no ``gymnasium`` here), sequential against pipelined. ``host_overlap.py``, ``run_benchmark.py``
   and ``seed_queue.py`` run on the CPU only, as the phase's last line says. The phases 59-62 print their total time.

Every path prints its env-steps/s, ms per update, graph replays per chunk, capture time and the
device memory of its graph pool.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and the one before that the per-kernel
JSON record.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # float32 outside the tensor cores, same sheet
H100_BF16_OPS_PER_S = 989e12    # bf16 on the tensor cores, dense (1,979 with sparsity), same sheet, at 700 W

# the main path's widths and depth (bench.py's pixel pipeline)
E = 256        # envs
SLOTS = 512    # ring slots per env
CHUNKS = 3     # training chunks after the prefill chunk
T = 16         # env steps per chunk
BATCH = 32
SEED = 0

# the physics paths (bench.py:bench_physics_step) and the kernel phase
PHYS_E = 2048
PHYS_PATHS = (("HalfCheetah", 64), ("Ant", 16))  # (task, vector steps)
PHYS_TASKS = ("HalfCheetah", "Hopper", "Walker2d", "Ant", "Swimmer", "Reacher")
ROLLOUT_CHECKS = (16, 32, 64)

# the ViZDoom C51 script's obs ring (examples_torch/vizdoom/vizdoom_c51.py): 100,000 frames of 40*60*1 B, and the rows
# of one stacked gather (batch 64 x stack 4)
DOOM_RING, DOOM_ROW, DOOM_ROWS = 100_000, 40 * 60, 256

# the pixel paths' test phase (examples/atari/atari_dqn.py: test_num 10, eps_test 0.005)
TEST_E, TEST_EPS, TEST_EPISODES, TEST_CHUNK = 10, 0.005, 10, 128

# the CartPole paths (tests/test_dqn.py:17-48; reward threshold from upstream test/discrete/test_dqn.py:69)
CP_E, CP_T, CP_EPOCHS, CP_EPOCH_STEPS, CP_PREFILL, CP_THRESHOLD = 10, 10, 15, 5000, 1000, 195
DET_EPOCHS = 2  # the determinism phase

# the graph phase: program calls per side (eager warm-up, capture and replay, replay) and updates per burst
GRAPH_CALLS, GRAPH_K = 3, 8
GRAPH_ATOL = 1e-6  # losses, TD errors and parameters of graph against eager; expected 0
# capturable Adam on the card against Adam on the CPU: tests/test_torch_dqn.py's one-update tolerance
ADAM_STEPS, ADAM_ATOL, ADAM_CLOSE, ADAM_SHARE = 8, 2e-5, 2e-6, 0.999
Q_TOL, QD_TOL = 2e-4, 5e-3     # rtol = atol, as the JAX package holds its fused step
MIN_SHARE_INSIDE = 0.995       # of envs, on rollout states

# the on-policy graph phase: PPO on NormObs(HalfCheetah) with recompute_advantage, the rate schedule (over
# OPG_TOTAL updates) and a KL guard that trips after a rollout's first minibatch
OPG_E, OPG_T, OPG_REPEAT, OPG_BATCH, OPG_TOTAL, OPG_TARGET_KL = 64, 16, 3, 256, 100, 1e-6
# the PPO physics paths (bench.py:bench_mujoco_ppo: E 2048, T 32, repeat 4, batch 16384, iters 4); Ant at T = 16
PPO_E, PPO_REPEAT, PPO_BATCH, PPO_ITERS = 2048, 4, 16384, 4
PPO_PATHS = (("HalfCheetah", 32), ("Ant", 16))  # (task, rollout steps)
# bench.py:359-362 mujoco_ppo_16k, "the north-star configuration": bench_mujoco_ppo at E 16384, T 16, batch 65536,
# iters 2 (nothing cut)
PPO16K_E, PPO16K_T, PPO16K_BATCH, PPO16K_ITERS = 16384, 16, 65536, 2
# bench.py:186-232 bench_atari_update_burst: the pixel pipeline, a prefill of 64 collect steps at eps 0.05, then
# bursts of 64 DQN updates of batch 1024 (iters 4); bench.py:221-224 counts 18.7 MFLOP a frame for the NatureCNN's
# forward and four forwards' worth per sample (the online and the target forward, the backward twice a forward)
UB_PREFILL, UB_BATCH, UB_UPDATES, UB_ITERS, UB_FWD_FLOP = 64, 1024, 64, 4, 18.7e6
# PPO on CartPole (tests/test_onpolicy.py:17-53): 16 train envs, T 128, repeat 10, batch 256, epochs of 10,000 steps
PCP_E, PCP_T, PCP_REPEAT, PCP_BATCH, PCP_EPOCHS, PCP_EPOCH_STEPS = 16, 128, 10, 256, 20, 10000
PCP_REPLAYS = 5  # replays of each training graph, timed alone after the run
# examples/mujoco/mujoco_ppo.py's defaults, the depth cut from 30 epochs of 100,000 steps to 1 of 16,384 (8
# rollouts of 2,048 rows: 1,024 steps an env, past HalfCheetah's 1,000-step episode end, which the gSDE carry check
# needs)
MJ_E, MJ_T, MJ_REPEAT, MJ_BATCH, MJ_EPOCHS, MJ_EPOCH_STEPS = 16, 128, 10, 64, 1, 16_384

# the continuous off-policy paths: examples/mujoco/mujoco_{sac,td3,redq}.py's defaults (32 envs, T 4, one update
# per env step, batch 256, a 1 M-row replay, 256x256 nets, 10 test episodes), the depth cut to one epoch
OFF_E, OFF_T, OFF_BATCH, OFF_BUFFER, OFF_HID, OFF_TEST_E, OFF_REPLAYS = 32, 4, 256, 1_000_000, (256, 256), 10, 5
# sac_humanoid: examples/mujoco/mujoco_sac.py --task Humanoid's defaults (as OFF_PATHS), the random prefill cut from
# 10,000 steps to HUM_SAC_PREFILL and the epoch from 20,000 to HUM_SAC_EPOCH; the test phase's 10 episodes as eager
# chunks of HUM_TEST_CHUNK steps (a 128-step test chunk warmed up eagerly on the plain route would take minutes)
HUM_SAC_PREFILL, HUM_SAC_EPOCH, HUM_TEST_CHUNK = 128, 512, 32
OFF_PATHS = {  # name: (task, algorithm, random prefill steps, epoch steps (cut), prioritized replay)
    "sac_halfcheetah": ("HalfCheetah", "sac", 10_000, 1_250, False),
    "td3_ant_per": ("Ant", "td3", 10_000, 1_250, True),  # the prefill cut from the script's 25,000
    "redq_halfcheetah": ("HalfCheetah", "redq", 10_000, 1_250, False),
    "sac_humanoid": ("Humanoid", "sac", HUM_SAC_PREFILL, HUM_SAC_EPOCH, False),  # the plain route: no kernel
}
OFF_ALGOS = {"sac": dict(lr=1e-3, alpha=0.2), "td3": dict(lr=3e-4), "redq": dict(lr=1e-3, alpha="auto")}
# Pendulum (tests/test_continuous.py:22-86; threshold from upstream test/continuous/test_sac_with_il.py:86)
PEND_E, PEND_TEST_E, PEND_HID, PEND_BUFFER, PEND_BATCH, PEND_T, PEND_UTD = 8, 10, (128, 128), 50_000, 128, 8, 0.5
PEND_PREFILL, PEND_EPOCHS, PEND_EPOCH_STEPS, PEND_THRESHOLD = 2_000, 12, 4_000, -250
PEND_ALGOS = {"sac": dict(lr=3e-4, alpha="auto"), "td3": dict(lr=3e-4), "ddpg": dict(lr=1e-3)}

# NPG and TRPO: examples/mujoco/mujoco_{npg,trpo}.py's defaults (16 envs, T 64, batch 16,384, repeat 1, 64x64 nets,
# Adam 1e-3, 20 critic steps, 10 test episodes), the depth cut from 30 epochs of 100,000 steps to 1
TR_E, TR_T, TR_BATCH, TR_EPOCH_STEPS, TR_CRITIC_ITERS = 16, 64, 16384, 100_000, 20
TR_PATHS = ("npg_halfcheetah", "trpo_halfcheetah")
# TRPO on CartPole (tests/test_trust_region.py:26-55): 16 + 10 envs, T 128, batch 1,024, at most 15 epochs of 10,000
TCP_E, TCP_T, TCP_BATCH, TCP_EPOCHS, TCP_EPOCH_STEPS = 16, 128, 1024, 15, 10000
# bench.py:312-350 bench_mlp_ppo: E 4096, T 128, repeat 4, batch 16384, 8 timed megasteps
MLP_E, MLP_T, MLP_REPEAT, MLP_BATCH, MLP_ITERS = 4096, 128, 4, 16384, 8
# mujoco_ppo.py --sde: gSDE with sigma_init -2.0, the example path's other defaults, the depth cut to 1 epoch; the
# graph phase's chunks of 400 steps (the third crosses HalfCheetah's episode end at step 1,000)
SDE_SIGMA_INIT, SDE_EPOCHS, SDE_GRAPH_T = -2.0, 1, 400

# the penalty branch of physics_fused: the kernel phase pushes states into the floor (the root coordinate and its
# drop) and past joint limits (the noise's scale); the physics_penalty_halfcheetah path is bench_physics_step's twin
PEN_DROP = {"HalfCheetah": (1, 0.1), "Hopper": (1, 0.15), "Walker2d": (1, 0.15), "Ant": (2, 0.2)}
PEN_SCALE = 0.3
PEN_PATH = ("HalfCheetah", 64)
# Humanoid on the plain route (dynamics.step, no kernel in either package): E 2048, the depth cut from 64 vector
# steps to HUM_T
HUM_T = 2
# InvertedPendulum SAC (tests/test_mujoco_table.py:41-53 and its _run): 8 train and 10 test envs, 128x128 nets, lr
# 3e-4, alpha "auto", a 100,000-row replay, batch 256, T 8, 0.5 updates per env step, a prefill of 2,000 steps with
# the policy's own actions, at most 12 epochs of 5,000 steps; it must reach the table's 1,000
IP_E, IP_TEST_E, IP_HID, IP_BUFFER, IP_BATCH, IP_T, IP_UTD = 8, 10, (128, 128), 100_000, 256, 8, 0.5
IP_PREFILL, IP_EPOCHS, IP_EPOCH_STEPS, IP_THRESHOLD = 2_000, 12, 5_000, 1000.0

# the distributional and discrete Q family on the pixel pipeline (examples/atari/atari_{qrdqn,iqn,fqf,sac}.py)
DIST_KINDS = ("qrdqn", "iqn", "fqf", "discrete_sac")
DIST_CHUNKS = 2  # training chunks per run of their paths (the DQN path runs CHUNKS = 3)
DIST_T = 4  # env steps per chunk of their paths (the DQN path's T = 16): bursts of 102 updates, whose eager warm-up
#             and capture take most of a path's time
# their time to score (tests/test_distributional.py:run, :89-107): 10 train and 10 test envs, a 20,000-row replay,
# epochs of 5,000 steps, batch 64, T 10, 0.1 updates per env step, a 1,000-step prefill, eps 0.3 annealed to 0.1
DIST_SCORE = {"fqf_cartpole": 195.0, "bdqn_pendulum": -250.0}  # name: threshold
DS_E, DS_BUFFER, DS_EPOCH_STEPS, DS_BATCH, DS_T, DS_PREFILL, DS_EPOCHS = 10, 20_000, 5_000, 64, 10, 1_000, 15


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, warmup: int = 10, runs: int = 60, per_graph: int = 20) -> tuple[float, float]:
    """(device ms, eager ms) of one call of ``fn``, each a median over ``runs``.

    Device time: ``per_graph`` calls captured in a CUDA graph, replayed
    between two CUDA events, so that no host launch gap is counted (NaN for
    ``per_graph=0``, a function that cannot be captured). Eager time: CUDA
    events around one ordinary call, which includes the gap when the host
    launches slower than the device runs.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    eager = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        eager.append(a.elapsed_time(b))
    if per_graph == 0:  # a function that a CUDA graph cannot capture: eager time only
        return float("nan"), statistics.median(eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b) / per_graph)
    del graph
    return statistics.median(device), statistics.median(eager)


# ---------------------------------------------------------------------------
# the bench.py pixel env, batched (bench.py:86-117)
# ---------------------------------------------------------------------------
def make_synthetic_atari():
    from typing import NamedTuple

    import torch

    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.env.core import Box, Discrete, Env, EnvStep

    class PixState(NamedTuple):
        pos: torch.Tensor  # [E] int32
        t: torch.Tensor    # [E] int32

    class SyntheticAtari(Env):
        """84x84 uint8 frames from a cheap position-dependent pattern, ~500-step
        episodes; obs synthesis is negligible next to the CNN and the replay."""

        max_episode_steps = 108_000

        def __init__(self) -> None:
            self.observation_space = Box(low=0, high=255, shape=(84, 84, 1))
            self.action_space = Discrete(6)

        @staticmethod
        def _obs(s: PixState) -> torch.Tensor:
            row = torch.arange(84, dtype=torch.int32, device=s.pos.device)[:, None]
            col = torch.arange(84, dtype=torch.int32, device=s.pos.device)[None, :]
            img = (row * 7 + col * 13)[None] + s.pos[:, None, None]
            return (img % 251).to(torch.uint8)[..., None]

        def reset(self, num_envs, generator, device):
            z = torch.zeros(num_envs, dtype=torch.int32, device=device)
            s = PixState(z, z.clone())
            return s, self._obs(s)

        def step(self, state, action, generator):
            pos = state.pos + action.to(torch.int32) + 1
            t = state.t + 1
            terminated = torch.rand(pos.shape, generator=generator, device=pos.device) < 0.002
            s = PixState(pos, t)
            return EnvStep(
                state=s, obs=self._obs(s),
                reward=(action == pos % 6).to(torch.float32),
                terminated=terminated,
                truncated=(t >= self.max_episode_steps) & ~terminated,
                info=Batch(),
            )

    return SyntheticAtari()


# ---------------------------------------------------------------------------
def gather_phase(torch, gather) -> tuple[list[dict], list[str]]:
    """Bit-exactness on the card at the main path's and edge-case shapes, timing at the
    main path's shape. Returns ([JSON record without launches], report lines)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    lines = []
    n, row = 131072, 7056  # the main path's obs ring: 256 envs x 512 slots of 84*84*1 B
    src = torch.randint(0, 256, (n, row), dtype=torch.uint8, device="cuda", generator=g)
    cases = []
    for rows in (128, 4096):
        idx = torch.randint(0, n, (rows,), device="cuda", generator=g)
        cases += [(f"uint8[{n},{row}] x {rows} rows int64", src, idx),
                  (f"uint8[{n},{row}] x {rows} rows int32", src, idx.to(torch.int32))]
    f32 = torch.randn(1024, 5, device="cuda", generator=g)
    cases.append(("float32[1024,5] x 300 rows", f32, torch.randint(0, 1024, (300,), device="cuda", generator=g)))
    rag = torch.randint(0, 256, (513, 3), dtype=torch.uint8, device="cuda", generator=g)
    cases.append(("uint8[513,3] x 1000 rows", rag, torch.randint(0, 513, (1000,), device="cuda", generator=g)))
    rep = torch.tensor([5, 5, 5, 0, 512, 512, 7, 5, -4, 10_000], device="cuda")
    cases.append(("uint8[513,3] repeated and out-of-range indices", rag, rep))
    cases.append(("uint8 main ring, repeated indices", src, torch.full((128,), 77, device="cuda")))
    # the recurrent path's ring: 20,000 rows of 2 float32 (8 bytes), 64 samples x 4 frames per gather
    ring8 = torch.randn(20_000, 2, device="cuda", generator=g).view(torch.uint8)
    idx8 = torch.randint(0, 20_000, (256,), device="cuda", generator=g)
    cases.append(("uint8[20000,8] (float32[20000,2]) x 256 rows", ring8, idx8))
    # the ViZDoom C51 script's ring: 16 envs x 6,250 slots of 40*60*1 B, 64 samples x 4 frames per gather
    doom = torch.randint(0, 256, (DOOM_RING, DOOM_ROW), dtype=torch.uint8, device="cuda", generator=g)
    doom_idx = torch.randint(0, DOOM_RING, (DOOM_ROWS,), device="cuda", generator=g)
    cases.append((f"uint8[{DOOM_RING},{DOOM_ROW}] x {DOOM_ROWS} rows (the ViZDoom ring)", doom, doom_idx))
    for width in (16, 2032, 2064, 7057):  # around the 16-byte chunk and the block's edge
        edge = torch.randint(0, 256, (300, width), dtype=torch.uint8, device="cuda", generator=g)
        cases.append((f"uint8[300,{width}] x 200 rows", edge, torch.randint(-2, 302, (200,), device="cuda", generator=g)))
    max_err = 0.0
    for name, s, i in cases:
        out = gather.gather_rows(s, i)
        ref = gather.gather_rows_reference(s, i)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"gather_rows differs from its plain version: {name}")
        max_err = max(max_err, float((out.double() - ref.double()).abs().max()))
        lines.append(f"gather_rows bit-exact: {name}")

    timings = {}
    count = gather.launch_count()  # timing launches are not the main path's
    for rows in (128, 4096):
        idx = torch.randint(0, n, (rows,), device="cuda", generator=g)
        kern, kern_e = _time_ms(lambda: gather.gather_rows(src, idx))
        plain, plain_e = _time_ms(lambda: gather.gather_rows_reference(src, idx))
        lib, lib_e = _time_ms(lambda: src[idx])
        noop, _ = _time_ms(lambda: gather.launch_noop(rows, 256))
        again, _ = _time_ms(lambda: gather.gather_rows(src, idx))  # the drift within the call
        bound = (2 * rows * row + idx.numel() * idx.element_size()) / H100_HBM_BYTES_PER_S * 1e3
        timings[rows] = (kern, plain, lib, bound)
        lines.append(
            f"gather_rows {rows} rows x {row} B, device us (CUDA graph): kernel {kern * 1e3:.3f} (again {again * 1e3:.3f}) "
            f"plain {plain * 1e3:.3f} library(src[idx]) {lib * 1e3:.3f} empty launch of {rows} x 256 threads {noop * 1e3:.3f} "
            f"bound {bound * 1e3:.3f} (kernel at {bound / kern:.3f} of the bound's rate, {kern / lib:.3f} of the library's time); "
            f"eager us per call: kernel {kern_e * 1e3:.2f} plain {plain_e * 1e3:.2f} library {lib_e * 1e3:.2f}"
        )
    kern, kern_e = _time_ms(lambda: gather.gather_rows(ring8, idx8))
    plain, _ = _time_ms(lambda: gather.gather_rows_reference(ring8, idx8))
    lib, _ = _time_ms(lambda: ring8[idx8])
    bound = (2 * 256 * 8 + idx8.numel() * idx8.element_size()) / H100_HBM_BYTES_PER_S * 1e3
    lines.append(f"gather_rows 256 rows x 8 B (the recurrent path's stacked gather), device us (CUDA graph): kernel "
                 f"{kern * 1e3:.3f} plain {plain * 1e3:.3f} library(src[idx]) {lib * 1e3:.3f} bound {bound * 1e3:.4f}; "
                 f"eager us per call: kernel {kern_e * 1e3:.2f}")
    kern, _ = _time_ms(lambda: gather.gather_rows(doom, doom_idx))
    plain, _ = _time_ms(lambda: gather.gather_rows_reference(doom, doom_idx))
    lib, _ = _time_ms(lambda: doom[doom_idx])
    bound = (2 * DOOM_ROWS * DOOM_ROW + doom_idx.numel() * doom_idx.element_size()) / H100_HBM_BYTES_PER_S * 1e3
    doom_record = {"shape": f"uint8[{DOOM_RING},{DOOM_ROW}] x {DOOM_ROWS} rows", "ms": kern, "plain_ms": plain,
                   "library_ms": lib, "bound_ms": bound}
    lines.append(f"gather_rows {DOOM_ROWS} rows x {DOOM_ROW} B (the ViZDoom C51 ring, [{DOOM_RING}, {DOOM_ROW}]), "
                 f"device us (CUDA graph): kernel {kern * 1e3:.3f} plain {plain * 1e3:.3f} library(src[idx]) "
                 f"{lib * 1e3:.3f} bound {bound * 1e3:.3f} (kernel at {bound / kern:.3f} of the bound's rate, "
                 f"{kern / lib:.3f} of the library's time)")
    if gather.launch_count() == count:
        raise AssertionError("the timed gather_rows calls did not launch the kernel")
    kern, plain, lib, bound = timings[128]  # 32 samples x 4 frames on the main path
    record = {
        "name": "gather_rows", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/gather.cu",
        "replaces": "tianshou_tpu/ops/pallas/gather.py:79",
        "max_abs_err": max_err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": lib, "vizdoom": doom_record,
    }
    return [record], lines


def _touched_nodes(tree, values, depth: int) -> int:
    """Number of distinct tree nodes the descents of ``values`` read."""
    import torch

    idx = torch.ones(values.shape, dtype=torch.int64, device=values.device)
    read = []
    for _ in range(depth):
        left = tree[2 * idx]
        go_right = left < values
        read.append(2 * idx)
        values = torch.where(go_right, values - left, values)
        idx = 2 * idx + go_right.to(torch.int64)
    return int(torch.unique(torch.cat(read)).numel()) if read else 0


def sumtree_phase(torch, sumtree) -> tuple[list[dict], list[str]]:
    """Both sum-tree kernels on the card. The descent: exact equality with its plain version at the
    main path's, the PER path's (1000000 leaves, 256 values) and edge-case shapes, timing at the main path's shape (131072 leaves, 32 stratified
    queries) and at 4096 queries. The update: see :func:`_tree_update_checks`. Returns (the two JSON
    records without launches, report lines)."""
    from tianshou_tpu_torch.ops.segtree import SegmentTree

    g = torch.Generator(device="cuda").manual_seed(2)
    lines = []

    def rand(n):
        return torch.rand(n, device="cuda", generator=g)

    def filled(size, zero_share=0.0):
        st = SegmentTree(size)
        vals = rand(size) + 1e-3
        if zero_share:
            vals = torch.where(rand(size) < zero_share, 0.0, vals)
        return st, st.update(st.init("cuda"), torch.arange(size, device="cuda"), vals)

    def edge_values(st, tree):
        """Every prefix sum of the first leaves (a value equal to one goes left), 0, the total,
        values above it and a negative one."""
        total = st.total(tree)
        cum = torch.cumsum(tree[st.bound:st.bound + min(st.size, 256)], 0)
        return torch.cat([cum, torch.stack([total * 0, total, total * 1.5, total + 1e9, -total - 1])])

    cases = []
    # 1000000 leaves (bound 2**20): the TD3 Ant + PER path's replay, 256 values per update
    for size, batches in ((131072, (32, 4096)), (1000000, (256,)), (100000, (32,)), (16384, (257,)), (1, (5,))):
        st, tree = filled(size)
        for b in batches:
            cases.append((f"size {size} (bound {st.bound}) x {b} uniform values", st, tree, rand(b) * st.total(tree)))
        cases.append((f"size {size}: prefix sums, 0, total and beyond", st, tree, edge_values(st, tree)))
    st, tree = filled(100000, zero_share=0.5)
    cases.append(("size 100000, half the leaves at priority 0", st, tree,
                  torch.cat([rand(4096) * st.total(tree), edge_values(st, tree)])))
    st = SegmentTree(131072)
    cases.append(("size 131072, all-zero tree", st, st.init("cuda"), torch.cat([rand(32), torch.zeros(3, device="cuda")])))
    # a tree built by update with duplicate (the last write wins) and -1 / out-of-range indices
    st = SegmentTree(131072)
    idx = torch.randint(-1, 131072, (300000,), device="cuda", generator=g)
    idx[::1000] = 131072 + 5
    tree = st.update(st.init("cuda"), idx, rand(300000) * 3)
    tree = st.update(tree, torch.tensor([7, 7, -1, 7], device="cuda"), torch.tensor([1.0, 2.0, 9.0, 4.0], device="cuda"))
    if tree[st.bound + 7].item() != 4.0 or tree[0].item() != 0.0:
        raise AssertionError("SegmentTree.update: the last write did not win or node 0 was written")
    if not torch.equal(tree[1:st.bound], tree[2::2] + tree[3::2]):
        raise AssertionError("SegmentTree.update: an internal node is not the sum of its children")
    cases.append(("size 131072, tree from update with duplicate and dropped indices", st, tree,
                  torch.cat([rand(4096) * st.total(tree), edge_values(st, tree)])))
    cases.append(("size 131072, no values", st, tree, torch.zeros(0, device="cuda")))

    max_err = 0.0
    for name, st, tree, values in cases:
        out = st.get_prefix_sum_idx(tree, values)
        ref = sumtree.prefix_sum_idx_reference(tree, values, st.bound, st.depth, st.size)
        torch.cuda.synchronize()
        if out.dtype != torch.int64 or not torch.equal(out, ref):
            raise AssertionError(f"prefix_sum_idx differs from its plain version: {name}")
        if values.numel():
            max_err = max(max_err, float((out - ref).abs().max()))
        lines.append(f"prefix_sum_idx exact: {name}")

    # timing at the main path's tree: every leaf holds a priority, values are stratified
    st, tree = filled(131072)
    timings = {}
    count = sumtree.launch_count()  # timing launches are not the main path's
    for b in (32, 4096):
        values = ((rand(b) + torch.arange(b, device="cuda")) / b * st.total(tree)).contiguous()
        kern, kern_e = _time_ms(lambda: sumtree.prefix_sum_idx(tree, values, st.bound, st.depth, st.size))
        plain, plain_e = _time_ms(lambda: sumtree.prefix_sum_idx_reference(tree, values, st.bound, st.depth, st.size))
        # no single PyTorch call computes this function (a cumsum rounds differently); for information only
        two, _ = _time_ms(lambda: torch.searchsorted(torch.cumsum(tree[st.bound:], 0), values))
        nodes = _touched_nodes(tree, values, st.depth)
        by_bytes = (b * 4 + b * 8 + 4 * nodes) / H100_HBM_BYTES_PER_S * 1e3
        by_ops = 2 * b * st.depth / H100_FP32_OPS_PER_S * 1e3  # one compare and one subtract per level
        timings[b] = (kern, plain, max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations")
        lines.append(
            f"prefix_sum_idx bound {st.bound} x {b} values, device us (CUDA graph): kernel {kern * 1e3:.3f} "
            f"plain {plain * 1e3:.3f} bound {max(by_bytes, by_ops) * 1e3:.5f} ({nodes} distinct nodes read; by bytes "
            f"{by_bytes * 1e3:.5f}, by operations {by_ops * 1e3:.5f}); eager us per call: kernel {kern_e * 1e3:.2f} "
            f"plain {plain_e * 1e3:.2f}; cumsum+searchsorted (another rounding, no yardstick) {two * 1e3:.3f}"
        )
    if sumtree.launch_count() == count:
        raise AssertionError("the timed prefix_sum_idx calls did not launch the kernel")
    lines.append(f"prefix_sum_idx launch shape (log2 lanes per query, levels per trip, warps per block): "
                 f"B=32 {sumtree._descent_shape(32)}, B=4096 {sumtree._descent_shape(4096)}")
    kern, plain, bound, bound_by = timings[32]  # batch 32 on the main path
    record = {
        "name": "prefix_sum_idx", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/sumtree.cu",
        "replaces": "tianshou_tpu/ops/pallas/sumtree.py:63",
        "max_abs_err": max_err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None,
    }
    update_record, update_lines = _tree_update_checks(torch, sumtree)
    return [record, update_record], lines + update_lines


def _update_nodes(torch, index, bound: int, depth: int, size: int) -> tuple[int, int]:
    """(nodes an update of leaves ``index`` writes, nodes it reads without writing them): the kept
    distinct leaves and all their ancestors; the ancestors' children outside that set."""
    node = torch.unique(index[(index >= 0) & (index < size)]) + bound
    written, ancestors = [node], []
    for _ in range(depth):
        node = torch.unique(node // 2)
        written.append(node)
        ancestors.append(node)
    written = torch.cat(written)
    if not ancestors:
        return int(written.numel()), 0
    children = torch.cat([2 * torch.cat(ancestors), 2 * torch.cat(ancestors) + 1])
    return int(written.numel()), int((~torch.isin(children, written)).sum())


def _tree_update_checks(torch, sumtree) -> tuple[dict, list[str]]:
    """Exact equality of the sum-tree update kernel and its plain version on whole trees on the card
    (the main path's 131072 leaves and the PER path's 1000000, among others),
    timing at the training path's 32 leaves (priority writeback) and 256 leaves (the collector's add)
    on the main path's tree. Returns (JSON record without launches, report lines)."""
    from tianshou_tpu_torch.ops.segtree import SegmentTree

    g = torch.Generator(device="cuda").manual_seed(4)
    lines = []

    def rand(n):
        return torch.rand(n, device="cuda", generator=g)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), device="cuda", generator=g)

    def filled(size):
        st = SegmentTree(size)
        return sumtree.update_reference(st.init("cuda"), torch.arange(size, device="cuda"), rand(size) + 1e-3,
                                        st.bound, st.depth, st.size)

    cases = []  # (name, size, tree before, index, value)
    for size in (131072, 1000000, 100000, 16384, 1):  # whole trees from nothing
        st = SegmentTree(size)
        cases.append((f"size {size}: every leaf from an empty tree", size, st.init("cuda"),
                      torch.arange(size, device="cuda"), rand(size) + 1e-3))
    idx = randint(-1, 131072, 300000)
    idx[::1000] = 131072 + 5
    cases.append(("size 131072: 300000 indices with duplicates, -1 and beyond size", 131072,
                  SegmentTree(131072).init("cuda"), idx, rand(300000) * 3))
    main = filled(131072)
    cases.append(("main tree: [7, 7, -1, 7]", 131072, main, torch.tensor([7, 7, -1, 7], device="cuda"),
                  torch.tensor([1.0, 2.0, 9.0, 4.0], device="cuda")))
    for k in (32, 256, 1024, 1025):
        value = rand(k) * 2
        value[: k // 8] = 0.0  # zero priorities
        cases.append((f"main tree: {k} leaves, duplicates and -1", 131072, main, randint(-1, 131072, k), value))
    cases.append(("main tree: 256 leaves of one expanded priority", 131072, main,
                  torch.arange(256, device="cuda") * 512 + 17, torch.tensor(0.3, device="cuda").expand(256)))
    cases.append(("main tree: only dropped indices", 131072, main, torch.tensor([-1, 131072, -1], device="cuda"),
                  torch.ones(3, device="cuda")))
    cases.append(("size 100000: 700 leaves", 100000, filled(100000), randint(0, 100000, 700), rand(700)))
    # the TD3 Ant + PER path's tree: the writeback's 256 sampled leaves, the collector's 32 (one per env)
    per = filled(1000000)
    value = rand(256) * 2
    value[:32] = 0.0
    cases.append(("PER tree of 1000000: 256 leaves, duplicates and -1", 1000000, per, randint(-1, 1000000, 256), value))
    cases.append(("PER tree of 1000000: 32 leaves, one per env's slice", 1000000, per,
                  torch.arange(32, device="cuda") * 31250 + randint(0, 31250, 32), rand(32) + 0.5))

    max_err = 0.0
    for name, size, before, index, value in cases:
        st = SegmentTree(size)
        want = sumtree.update_reference(before.clone(), index, value, st.bound, st.depth, st.size)
        got = sumtree.update(before.clone(), index, value, st.bound, st.depth, st.size)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got.double() - want.double()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"tree_update differs from its plain version: {name}")
        if not torch.equal(got[1:st.bound], got[2::2] + got[3::2]) or got[0].item() != 0.0:
            raise AssertionError(f"tree_update: the tree's invariant does not hold: {name}")
        lines.append(f"tree_update bit-exact: {name}")
    # through SegmentTree.update, as the buffer calls it: the last write wins, node 0 stays 0
    st = SegmentTree(131072)
    tree = st.update(main.clone(), torch.tensor([7, 7, -1, 7], device="cuda"), torch.tensor([1.0, 2.0, 9.0, 4.0], device="cuda"))
    if tree[st.bound + 7].item() != 4.0 or tree[0].item() != 0.0:
        raise AssertionError("SegmentTree.update: the last write did not win or node 0 was written")

    # timing on the main path's tree: the writeback's sampled leaves, the collector's one leaf per env
    st, tree = SegmentTree(131072), main
    timings = {}
    count = sumtree.update_launch_count()  # timing launches are not the main path's
    for k, index in ((32, sumtree.prefix_sum_idx(tree, rand(32) * st.total(tree), st.bound, st.depth, st.size)),
                     (256, torch.arange(256, device="cuda") * 512 + 100)):
        value = rand(k) + 0.5
        kern, kern_e = _time_ms(lambda: sumtree.update(tree, index, value, st.bound, st.depth, st.size))
        # the plain version clears node 0 from a host scalar, which a CUDA graph cannot capture: eager time
        _, plain = _time_ms(lambda: sumtree.update_reference(tree, index, value, st.bound, st.depth, st.size), per_graph=0)
        written, read = _update_nodes(torch, index, st.bound, st.depth, st.size)
        by_bytes = (12 * k + 4 * written + 4 * read) / H100_HBM_BYTES_PER_S * 1e3
        by_ops = (written - int(torch.unique(index).numel())) / H100_FP32_OPS_PER_S * 1e3  # one add per ancestor
        timings[k] = (kern, plain, max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations")
        lines.append(
            f"tree_update bound {st.bound} x {k} leaves: kernel {kern * 1e3:.3f} us device (CUDA graph), "
            f"{kern_e * 1e3:.2f} eager; plain {plain * 1e3:.2f} eager; bound {max(by_bytes, by_ops) * 1e3:.5f} "
            f"({written} nodes written, {read} read beside them; by bytes {by_bytes * 1e3:.5f}, by operations "
            f"{by_ops * 1e3:.5f})"
        )
    if sumtree.update_launch_count() == count:
        raise AssertionError("the timed tree_update calls did not launch the kernel")
    kern, plain, bound, bound_by = timings[32]  # the priority writeback, once per update
    record = {
        "name": "tree_update", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/sumtree.cu",
        "replaces": "tianshou_tpu/ops/segtree.py:45",
        "max_abs_err": max_err, "ms": kern, "plain_ms": plain, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None, "plain_timing": "eager", "ms_256": timings[256][0],
        "plain_ms_256": timings[256][1], "bound_ms_256": timings[256][2],
    }
    return record, lines


def _launches(gather, sumtree, physics_fused) -> dict[str, int]:
    return {"gather_rows": gather.launch_count(), "prefix_sum_idx": sumtree.launch_count(),
            "tree_update": sumtree.update_launch_count(), "physics_fused": physics_fused.launch_count()}


def build_pipeline(torch, kind: str = "dqn"):
    """The bench.py pipeline (``_build_atari_pipeline``) in the port, with DQN over a uniform
    replay (``kind="dqn"``), RainbowDQN over a prioritized one (``kind="rainbow"``,
    examples/atari/atari_rainbow.py), or one of ``DIST_KINDS`` over a uniform one with its example
    script's net and settings: returns (algo, train state, buffer, buffer state, collector)."""
    from tianshou_tpu_torch.algorithm.modelfree.c51 import RainbowDQN
    from tianshou_tpu_torch.algorithm.modelfree.discrete_sac import DiscreteSAC
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.modelfree.fqf import FQF
    from tianshou_tpu_torch.algorithm.modelfree.iqn import IQN
    from tianshou_tpu_torch.algorithm.modelfree.qrdqn import QRDQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.wrappers import FrameStack
    from tianshou_tpu_torch.models.atari import DQNet, ImplicitQuantileAtariNet, QRDQNet, RainbowAtariNet

    device = DEV
    torch.manual_seed(SEED)
    env = FrameStack(make_synthetic_atari(), 4)
    common = dict(action_space=env.action_space, gamma=0.99, n_step_return_horizon=3,
                  target_update_freq=500, eps_training=0.05, eps_inference=TEST_EPS)
    ring = dict(total_size=E * SLOTS, buffer_num=E, stack_num=4, save_only_last_obs=True)
    buffer = VectorReplayBuffer(**ring)
    if kind == "dqn":
        algo = DQN(model=DQNet(action_dim=6), optim=AdamOptimizerFactory(lr=1e-4), **common)
    elif kind == "rainbow":
        algo = RainbowDQN(model=RainbowAtariNet(action_dim=6, num_atoms=51), optim=AdamOptimizerFactory(lr=6.25e-5),
                          num_atoms=51, v_min=-10.0, v_max=10.0, **common)
        buffer = PrioritizedVectorReplayBuffer(alpha=0.6, beta=0.4, **ring)
    elif kind == "qrdqn":  # examples/atari/atari_qrdqn.py
        algo = QRDQN(model=QRDQNet(action_dim=6, num_quantiles=200), optim=AdamOptimizerFactory(lr=5e-5),
                     num_quantiles=200, **common)
    elif kind == "iqn":  # examples/atari/atari_iqn.py
        algo = IQN(model=ImplicitQuantileAtariNet(action_dim=6), optim=AdamOptimizerFactory(lr=5e-5), sample_size=32,
                   online_sample_size=8, target_sample_size=8, **common)
    elif kind == "fqf":  # examples/atari/atari_fqf.py (its fraction optimizer the default RMSprop)
        algo = FQF(model=ImplicitQuantileAtariNet(action_dim=6), optim=AdamOptimizerFactory(lr=5e-5), num_fractions=32,
                   ent_coef=10.0, **common)
    elif kind == "discrete_sac":  # examples/atari/atari_sac.py
        algo = DiscreteSAC(actor=DQNet(action_dim=6), critic=DQNet(action_dim=6), action_space=env.action_space,
                           policy_optim=AdamOptimizerFactory(lr=1e-4), critic_optim=AdamOptimizerFactory(lr=1e-4),
                           alpha="auto", gamma=0.99, tau=0.005, n_step_return_horizon=3)
    else:
        raise ValueError(f"unknown pipeline {kind!r}")
    ts = algo.init(device)
    buf_state = buffer.init(Batch(
        obs=torch.zeros((84, 84, 1), dtype=torch.uint8), act=torch.tensor(0), rew=torch.tensor(0.0),
        terminated=torch.tensor(False), truncated=torch.tensor(False),
        obs_next=torch.zeros((84, 84, 1), dtype=torch.uint8),
    ), device=device)
    coll = DeviceCollector(VectorDeviceEnv(env, E, device=device), algo, buffer)
    return algo, ts, buffer, buf_state, coll


def make_test_collector(algo):
    """The pixel paths' test collector: ``TEST_E`` envs of ``FrameStack(SyntheticAtari(), 4)``, no buffer."""
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.wrappers import FrameStack

    return DeviceCollector(VectorDeviceEnv(FrameStack(make_synthetic_atari(), 4), TEST_E, device=DEV), algo, None)


def _check_tests(name: str, tests: list, n_phases: int) -> None:
    """Every test phase returned ``TEST_EPISODES`` episodes with finite returns."""
    import numpy as np

    if len(tests) != n_phases:
        raise AssertionError(f"{name}: {len(tests)} test phases, expected {n_phases}")
    for stats in tests:
        if stats.n_collected_episodes != TEST_EPISODES or len(stats.returns) != TEST_EPISODES \
                or not np.isfinite(stats.returns).all():
            raise AssertionError(f"{name}: a test phase returned {stats.n_collected_episodes} episodes, "
                                 f"returns {stats.returns}")


def _check_tree(torch, buffer, state, gen, batch_size: int = BATCH) -> str:
    """The prioritized state after training: the tree's invariant, where its mass lies, the
    priority range, a fresh batch's weights, and both sum-tree kernels on this tree against their
    plain versions (after the path's launch counts were read). Returns a report line."""
    tree, bound = state.tree, buffer.segtree.bound
    envs, slots = buffer.num_envs, buffer.capacity
    if not torch.equal(tree[1:bound], tree[2::2] + tree[3::2]):
        raise AssertionError("an internal node of the sum tree is not the sum of its two children")
    if tree[0].item() != 0.0:
        raise AssertionError("node 0 of the sum tree was written")
    leaves = tree[bound:bound + envs * slots].reshape(envs, slots)
    stored = torch.arange(slots, device=tree.device)[None, :] < state.base.size[:, None]
    if not bool((leaves[stored] > 0).all()) or not bool((leaves[~stored] == 0).all()):
        raise AssertionError("stored rows must carry priority and never-written slots none")
    lo, hi = state.min_prio.item(), state.max_prio.item()
    if not 0 < lo <= hi:
        raise AssertionError(f"priority range [{lo}, {hi}] is off")
    batch, idx = buffer.sample(state, gen, batch_size)
    w = batch.weight
    if not bool(((w > 0) & (w <= 1)).all()) or not bool(stored.reshape(-1)[idx].all()):
        raise AssertionError("a sampled batch's weights must lie in (0, 1] and its rows be stored ones")
    # both kernels on this tree, at the path's shapes, against their plain versions
    from tianshou_tpu_torch.ops.kernels import sumtree

    st = buffer.segtree
    u = (torch.rand(batch_size, device=tree.device, generator=gen) + torch.arange(batch_size, device=tree.device)) \
        / batch_size * st.total(tree)
    if not torch.equal(st.get_prefix_sum_idx(tree, u), sumtree.prefix_sum_idx_reference(tree, u, bound, st.depth, st.size)):
        raise AssertionError("prefix_sum_idx differs from its plain version on the path's tree")
    for index in (idx, idx[:envs]):  # the writeback's sampled leaves; as many as the collector writes
        value = torch.rand(index.shape, device=tree.device, generator=gen) + 0.5
        got = sumtree.update(tree.clone(), index, value, bound, st.depth, st.size)
        if not torch.equal(got, sumtree.update_reference(tree.clone(), index, value, bound, st.depth, st.size)):
            raise AssertionError(f"tree_update of {index.numel()} leaves differs from its plain version on the path's tree")
    return (f"sum tree: {2 * bound} nodes, invariant holds exactly, total {tree[1].item():.3f}, "
            f"{int(stored.sum())} leaves with priority, min_prio {lo:.6f} max_prio {hi:.6f}, "
            f"batch weights in [{w.min().item():.4f}, {w.max().item():.4f}]; on this tree the descent of "
            f"{batch_size} stratified values and updates of {idx.numel()} and {min(envs, idx.numel())} leaves "
            f"bit-exact against their plain versions")


def _graph_report(pool, replays_per_chunk: float) -> str:
    """Capture time, graph replays per chunk and pool memory of a trainer's or a rollout's graphs."""
    captures = ", ".join(f"{g.name} {g.capture_s:.2f} s" for g in pool.graphs if g.capture_s is not None)
    return (f"graph launches per chunk {replays_per_chunk:g}, capture time {captures}, "
            f"graph pool {pool.memory_bytes() / 2**20:.1f} MiB of device memory")


def main_path(torch, kind: str, fused: bool = False, chunks: int = CHUNKS, steps: int = T):
    """Train the pipeline of ``kind`` through the graphed trainer (with ``fused`` as ONE graph per
    chunk): a first ``run`` of the random prefill and ``chunks`` chunks (the first chunk of each
    program its eager warm-up, the second its capture), then a second ``run`` of ``chunks`` chunks
    that only replays, and that is timed. Returns (second result, {kernel: launches} over both runs,
    report lines)."""
    from tianshou_tpu_torch.data.buffer.prio import PrioState
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    name = f"{kind}{' fused_megastep' if fused else ''}"
    algo, ts, buffer, buf_state, coll = build_pipeline(torch, kind)
    init_params = [p.detach().clone() for p in ts.model.parameters()]
    tests = []  # the CollectStats of every test phase

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    # one epoch per run, so one test phase at the end of each run
    params = OffPolicyTrainerParams(
        max_epochs=1, epoch_num_steps=chunks * steps * E, batch_size=BATCH,
        collection_step_num_env_steps=steps, update_per_step=0.1, start_steps=steps * E, verbose=False,
        fused_megastep=fused, test_step_num_episodes=TEST_EPISODES, compute_score_fn=score,
    )
    trainer = OffPolicyTrainer(algo, coll, make_test_collector(algo), buffer, params)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    first = trainer.run(ts, buf_state, gen)
    graphs = list(trainer.graph_pool.graphs)
    train_graphs = [g for g in graphs if not g.name.startswith("test_chunk")]
    test_graph = next(g for g in graphs if g.name.startswith("test_chunk"))
    replays, test_replays = sum(g.replays for g in train_graphs), test_graph.replays
    trainer.params.start_steps = 0  # the second run only replays
    res = trainer.run(first.train_state, first.buf_state, gen)
    launches = _launches(gather, sumtree, physics_fused)

    lines = []
    if trainer.graph_pool.graphs != graphs or any(g.graph is None for g in graphs):
        raise AssertionError(f"{name} path: the second run built programs anew")
    if len(train_graphs) != (1 if fused else 2) or len(graphs) != len(train_graphs) + 1:
        raise AssertionError(f"{name} path: programs {[g.name for g in graphs]}")
    replays_per_chunk = (sum(g.replays for g in train_graphs) - replays) / chunks
    if replays_per_chunk != len(train_graphs):
        raise AssertionError(f"{name} path: {replays_per_chunk} graph replays per chunk of the second run")
    _check_tests(f"{name} path", tests, 2)
    test_chunks = [t.n_collected_steps // (TEST_CHUNK * TEST_E) for t in tests]
    if test_graph.replays - test_replays != test_chunks[1]:
        raise AssertionError(f"{name} path: {test_graph.replays - test_replays} test chunk replays for "
                             f"{test_chunks[1]} chunks of the second run's test phase")
    ts, state = res.train_state, res.buf_state
    bs = state.base if isinstance(state, PrioState) else state
    tensors = [*ts.model.parameters(), *ts.target.parameters(), ts.step, *ts.hparams.values(), bs.cursor, bs.size,
               bs.last_idx, *bs.data.values()]
    if isinstance(state, PrioState):
        tensors += [state.tree, state.max_prio, state.min_prio]
    if not all(t.device.type == "cuda" for t in tensors):
        raise AssertionError(f"{name} path: a tensor left the device")
    loss = res.last_chunk_stats.loss
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"{name} path: non-finite loss in the last chunk: {loss}")
    if not all(bool(torch.isfinite(p).all()) for p in ts.model.parameters()):
        raise AssertionError(f"{name} path: non-finite parameters after training")
    if all(torch.equal(a, b) for a, b in zip(init_params, ts.model.parameters())):
        raise AssertionError(f"{name} path: training left the parameters unchanged")
    n_updates = max(1, round(0.1 * steps * E))
    expect_updates = 2 * chunks * n_updates
    if res.gradient_step != expect_updates or int(ts.step) != expect_updates:
        raise AssertionError(f"{name} path: {res.gradient_step} updates ({int(ts.step)} on the device), "
                             f"expected {expect_updates}")
    collect_steps = (2 * chunks + 1) * steps  # the prefill chunk and the training chunks, one add per step
    if bs.size.min().item() != min(SLOTS, collect_steps):
        raise AssertionError(f"{name} path: ring sizes {bs.size.min().item()}..{bs.size.max().item()} are off")
    prio = isinstance(state, PrioState)
    expect = {"gather_rows": 2 * res.gradient_step, "prefix_sum_idx": res.gradient_step if prio else 0,
              "tree_update": res.gradient_step + collect_steps if prio else 0, "physics_fused": 0}
    if launches != expect:
        raise AssertionError(f"{name} path: kernel launches {launches} for {res.gradient_step} updates, expected {expect}")
    train_s = res.timing["collect"] + res.timing["update"]
    lines.append(
        f"{name} path: E={E} T={steps} chunks={chunks}+{chunks} updates={res.gradient_step} batch={BATCH} "
        f"ring uint8 {tuple(bs.data.obs.shape)} x2 ({bs.data.obs.numel() / 1e9:.3f} GB each)"
    )
    lines.append(
        f"{name} path, first run (prefill, then the eager warm-up chunk and the capture chunk): "
        f"{(first.timing['collect'] + first.timing['update']) / chunks * 1e3:.1f} ms per chunk, "
        f"prefill {first.timing['prefill'] * 1e3:.1f} ms"
    )
    what = "collect + update as one graph" if fused else (
        f"collect {res.timing['collect'] / chunks * 1e3:.1f} ms, update {res.timing['update'] / chunks * 1e3:.1f} ms")
    lines.append(
        f"{name} path, second run (graph replays only): env_steps_per_s {chunks * steps * E / train_s:.1f} "
        f"ms_per_chunk {train_s / chunks * 1e3:.1f} ({what}) = {train_s / (chunks * n_updates) * 1e3:.3f} ms per update "
        f"(collect included); {_graph_report(trainer.graph_pool, replays_per_chunk)}; "
        f"loss_last_chunk_mean {float(loss.mean()):.5f} gather_launches {launches['gather_rows']} "
        f"sumtree_launches {launches['prefix_sum_idx']} tree_update_launches {launches['tree_update']}"
    )
    lines.append(
        f"{name} path, test phases ({TEST_E} envs, eps_inference {TEST_EPS}, {TEST_EPISODES} episodes in chunks of "
        f"{TEST_CHUNK} steps, timed apart from collect and update): first run {first.timing['test']:.3f} s in "
        f"{test_chunks[0]} chunks (eager warm-up chunk and capture included), second run {res.timing['test']:.3f} s "
        f"in {test_chunks[1]} chunks of replays ({res.timing['test'] / test_chunks[1] * 1e3:.1f} ms per chunk); "
        f"test chunk capture {test_graph.capture_s:.2f} s; returns mean {tests[1].returns.mean():.3f} "
        f"length mean {tests[1].lens.mean():.1f}; share of the second run's wall {res.timing['test'] / res.train_time:.3f}"
    )
    if isinstance(state, PrioState):
        lines.append(f"{name} path: " + _check_tree(torch, buffer, state, gen))
    if kind in DIST_KINDS:
        lines.append(f"{name} path: " + _trace_burst(torch, trainer, ts, state, gen, n_updates))
    return res, launches, lines


TRACE_TRIES = 3  # traced replays of a burst, until one trace holds every kernel (the tracer can drop records)


def _trace_burst(torch, trainer, ts, state, gen, n_updates: int) -> str:
    """One update burst of a pixel path replayed (its graph already captured) between CUDA events, then
    once under ``torch.profiler`` (device activity only): device ms per update, kernels per update, the
    ``gather_rows`` kernels (exactly 2 per update, or it raises) and their share of busy time, and the
    idle share: the traced busy time against the untraced replay's time, and against the traced span
    from the first kernel's start to the last kernel's end, which the tracer stretches. A trace that
    lacks gathers is taken again, up to ``TRACE_TRIES`` traces, and the line says so: CUPTI can drop
    activity records (one trace of 100 discrete BCQ updates held 58,317 of the 58,590 kernels that every
    other trace of the same replay holds, and 198 of its 200 gathers, while the launch counters saw every
    one); it raises when no trace holds 2 gathers per update. Returns a report line."""
    from torch.profiler import ProfilerActivity, profile

    graph = next(g for g in trainer.graph_pool.graphs if g.name.startswith("update_burst"))
    replays = graph.replays
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    trainer.update_burst(ts, state, gen, n_updates)
    b.record()
    b.synchronize()
    short = []  # (kernels, gathers) of each trace that lacked gathers
    for tries in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.update_burst(ts, state, gen, n_updates)
            torch.cuda.synchronize()
        if graph.replays != replays + 1 + tries:
            raise AssertionError(f"the traced update burst was not a replay of the captured graph "
                                 f"({graph.replays - replays})")
        busy = kernels = gathers = gather_us = 0.0
        first, last = float("inf"), float("-inf")
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
                us = e.duration_ns() / 1e3
                busy, kernels = busy + us, kernels + 1
                first, last = min(first, e.start_ns()), max(last, e.start_ns() + e.duration_ns())
                if "gather_spread_kernel" in e.name() or "gather_bytes_kernel" in e.name():  # csrc/gather.cu
                    gathers, gather_us = gathers + 1, gather_us + us
        if kernels > 0 and gathers == 2 * n_updates:
            break
        short.append((int(kernels), int(gathers)))
    else:
        raise AssertionError(f"the traced update burst shows (kernels, gather_rows) {short} in {TRACE_TRIES} traces "
                             f"for {n_updates} updates")
    span = max(last - first, 1) / 1e3
    retraced = f" (traced again after traces that held (kernels, gathers) {short})" if short else ""
    untraced = a.elapsed_time(b)
    return (f"one replayed update burst of {n_updates} updates{retraced}: {untraced:.3f} ms between CUDA events "
            f"({untraced / n_updates:.4f} ms per update); traced: device busy {busy / 1e3:.3f} ms, idle share "
            f"{1 - busy / 1e3 / untraced:.4f} against the untraced replay (a tracer's gaps widen: "
            f"{1 - busy / span:.4f} of the traced span of {span / 1e3:.3f} ms); kernels per update {kernels / n_updates:.1f}, "
            f"device ms per update {busy / 1e3 / n_updates:.4f}; gather_rows kernels {int(gathers)} "
            f"({gathers / n_updates:g} per update), {gather_us / busy:.4f} of busy")


def graph_phase(torch, kind: str) -> list[str]:
    """The trainer's programs as CUDA graphs against the eager loop, on the pipeline of ``kind``.

    From one prefilled state and one generator state, two sides run on deep copies: the trainer's
    programs (the collect chunk and the whole burst, each one graph) and the plain eager loop
    (``collector.collect`` and ``algo.update`` on the card). Each side runs ``GRAPH_CALLS`` collect chunks of T steps and then ``GRAPH_CALLS``
    bursts of ``GRAPH_K`` updates; a program's first call is its eager warm-up, the second its
    capture and first replay, the third a replay. Sampled indices, rings, the collect state, the
    collect output and the sum tree must be bit-identical; losses, TD errors and parameters within
    ``GRAPH_ATOL`` (expected exact: cuDNN is held to deterministic algorithms here, and both sides
    run the same kernels in the same order); the kernel launches the same."""
    import copy

    from tianshou_tpu_torch.data.buffer.prio import PrioState
    from tianshou_tpu_torch.ops.kernels import counters
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    algo, ts, buffer, bs, coll = build_pipeline(torch, kind)
    prio = isinstance(bs, PrioState)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    coll.collect(ts, cstate, bs, gen, T, random=True)  # a prefill chunk: 16 rows per env to sample from
    sample_indices = buffer.sample_indices
    sides = {}
    for side in ("graph", "eager"):
        s_ts, s_bs, s_cs = copy.deepcopy((ts, bs, cstate))
        s_gen = torch.Generator(device="cuda")
        s_gen.set_state(gen.get_state())
        sides[side] = dict(ts=s_ts, bs=s_bs, cstate=s_cs, gen=s_gen, outs=[], stats=[])
    del ts, bs, cstate
    for side, sd in sides.items():
        buffer.sample_indices, log = _logged(torch, sample_indices, (GRAPH_CALLS * GRAPH_K, BATCH))
        trainer = None
        if side == "graph":
            trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(
                batch_size=BATCH, collection_step_num_env_steps=T, verbose=False))
        before = counters.snapshot()
        for _ in range(GRAPH_CALLS):
            if trainer is None:
                out = coll.collect(sd["ts"], sd["cstate"], sd["bs"], sd["gen"], T)[2]
            else:
                out = trainer.collect_chunk(sd["ts"], sd["cstate"], sd["bs"], sd["gen"], T)
            sd["outs"].append(out.map(torch.clone))
        for _ in range(GRAPH_CALLS):
            if trainer is None:
                stats = [algo.update(sd["ts"], buffer, sd["bs"], sd["gen"], BATCH)[2] for _ in range(GRAPH_K)]
                stats = {k: torch.stack([s[k] for s in stats]) for k in stats[0].keys()}
            else:
                stats = trainer.update_burst(sd["ts"], sd["bs"], sd["gen"], GRAPH_K)
            sd["stats"].append({k: v.clone() for k, v in stats.items()})
        torch.cuda.synchronize()
        after = counters.snapshot()
        sd["launches"] = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        sd["idx"] = log
        if trainer is not None:
            sd["graphs"] = {g.name.split()[0]: (g.replays, g.capture_s) for g in trainer.graph_pool.graphs}
            sd["pool_mib"] = trainer.graph_pool.memory_bytes() / 2**20
    buffer.sample_indices = sample_indices
    torch.backends.cudnn.deterministic = deterministic

    eager = sides["eager"]
    if int((eager["idx"] < 0).sum()) != 0:
        raise AssertionError(f"graph phase {kind}: the eager loop sampled {int(eager['idx'][:, 0].ge(0).sum())} batches")
    sd, worst = sides["graph"], 0.0
    replays = {name: n for name, (n, _) in sd["graphs"].items()}
    expect = {"collect_chunk": GRAPH_CALLS - 1, "update_burst": GRAPH_CALLS - 1}
    if replays != expect:
        raise AssertionError(f"graph phase {kind}: replays {replays}, expected {expect}")
    if not torch.equal(sd["idx"], eager["idx"]):
        raise AssertionError(f"graph phase {kind}: sampled indices differ from eager")
    if torch.equal(sd["idx"][GRAPH_K:2 * GRAPH_K], sd["idx"][2 * GRAPH_K:]):
        raise AssertionError(f"graph phase {kind}: two replays drew the same indices")
    for call in range(GRAPH_CALLS):
        for k, v in eager["outs"][call].items():
            if not torch.equal(sd["outs"][call][k], v):
                raise AssertionError(f"graph phase {kind}: collect output {k} of call {call} differs")
        for k, v in eager["stats"][call].items():
            worst = max(worst, float((sd["stats"][call][k] - v).abs().max()))
    for a, b in ((sd["ts"].model, eager["ts"].model), (sd["ts"].target, eager["ts"].target)):
        for x, y in zip(a.state_dict().values(), b.state_dict().values()):
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    for x, y in zip(_optimizer_state(sd["ts"]), _optimizer_state(eager["ts"])):  # every optimizer's state
        worst = max(worst, float((x.detach().float() - y.detach().float()).abs().max()))
    if not int(sd["ts"].step) == int(eager["ts"].step) == GRAPH_CALLS * GRAPH_K:
        raise AssertionError(f"graph phase {kind}: step {int(sd['ts'].step)}, eager {int(eager['ts'].step)}")
    sb, eb = sd["bs"], eager["bs"]
    pairs = [(sb.tree, eb.tree), (sb.max_prio, eb.max_prio), (sb.min_prio, eb.min_prio)] if prio else []
    sb, eb = (sb.base, eb.base) if prio else (sb, eb)
    pairs += [(sb.cursor, eb.cursor), (sb.size, eb.size), (sb.last_idx, eb.last_idx),
              *zip(sb.data.values(), eb.data.values()), *zip(_leaves(sd["cstate"]), _leaves(eager["cstate"]))]
    if not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f"graph phase {kind}: rings, sum tree or collect state differ from eager")
    if worst > GRAPH_ATOL:
        raise AssertionError(f"graph phase {kind}: losses or parameters differ by {worst:.3e} > {GRAPH_ATOL}")
    if sd["launches"] != eager["launches"]:
        raise AssertionError(f"graph phase {kind}: launches {sd['launches']}, eager {eager['launches']}")
    test_lines = [test_chunk_check(torch, algo, coll, buffer, sd["ts"])] if kind == "dqn" else []
    factory = algo.critic_optim if kind == "discrete_sac" else algo.optim
    return test_lines + [
        f"graph phase {kind}: " + adam_check(torch, factory, list(sd["ts"].model.parameters())),
        f"graph phase {kind}, graphs against eager: {GRAPH_CALLS} collect chunks of T={T} and "
        f"{GRAPH_CALLS} x {GRAPH_K} updates; sampled indices, rings, collect state and output"
        f"{' and the sum tree' if prio else ''} bit-identical; losses, TD errors and parameters max |diff| "
        f"{worst:.3e} (tolerance {GRAPH_ATOL}); launches {sd['launches']} as eager; replays and capture s "
        f"{ {n: (r, round(c, 3)) for n, (r, c) in sd['graphs'].items()} }; pool {sd['pool_mib']:.1f} MiB"
    ]


def _logged(torch, fn, shape: tuple[int, ...], device: str = "cuda"):
    """``fn`` wrapped so that each of its results is written into the next row of a log of ``shape`` on ``device``
    (-1 where nothing was written), in order and without a host sync: a graph's replays write the next rows too.
    Returns (the wrapped ``fn``, the log). The row counter lives in the wrapper: a graph that captured it must not
    be replayed once the wrapper is gone."""
    log = torch.full(shape, -1, dtype=torch.int64, device=device)
    row = torch.zeros((), dtype=torch.int64, device=device)

    def logging(*args):
        out = fn(*args)
        log.index_copy_(0, row.view(1), out.unsqueeze(0))
        row.add_(1)
        return out

    return logging, log


def update_burst_pixels_path(torch, smi: str):
    """Phase 57: ``bench.py:bench_atari_update_burst`` in the port. The pixel pipeline of phase 5 at its widths
    (``build_pipeline(torch, "dqn")``: E = 256, the uint8 rings of 256 x 512 frames), prefilled by ``UB_PREFILL``
    collect steps at eps 0.05; then ``OffPolicyTrainer.update_burst`` of ``UB_UPDATES`` DQN updates of batch
    ``UB_BATCH`` as one CUDA graph: an eager warm-up, a capture, ``UB_ITERS`` timed replays. cuDNN is held to
    deterministic algorithms (the timed replays too), so that from one state and one generator state the graph's
    bursts and the eager loop (``algo.update`` on a deep copy of the train state, as many updates) sample
    bit-identical indices (logged on the device, two small kernels per update) and agree on losses, weights,
    target and Adam's state within ``GRAPH_ATOL``. Counters zeroed just before and read just after the graph's
    calls: ``gather_rows`` exactly twice per update, every call at ``UB_BATCH`` x 4 rows of 7,056 B; one such
    gather on the run's own ring and rows bit-exact against ``src[idx]`` and timed beside it and its byte bound;
    one replayed burst traced. Returns ({kernel: launches}, lines, the gather's numbers at that shape)."""
    import copy

    from tianshou_tpu_torch.data.buffer import base as buffer_base
    from tianshou_tpu_torch.ops.kernels import gather
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    algo, ts, buffer, bs, coll = build_pipeline(torch, "dqn")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    t0 = time.perf_counter()
    coll.collect(ts, cstate, bs, gen, UB_PREFILL)  # the policy at eps_training 0.05, as bench.py's prefill scan
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    init = [p.detach().clone() for p in ts.model.parameters()]
    e_ts = copy.deepcopy(ts)
    e_gen = torch.Generator(device="cuda")
    e_gen.set_state(gen.get_state())
    calls = 2 + UB_ITERS
    n = calls * UB_UPDATES
    shapes, first = set(), []  # (rows, row bytes) of every gather run or captured; the first gather's (src, rows)
    real_gather, sample_indices = buffer_base.gather_rows, buffer.sample_indices

    def recording_gather(src, idx):
        shapes.add((idx.shape[0], src.shape[1] * src.element_size()))
        if not first:
            first.append((src, idx.clone()))
        return real_gather(src, idx)

    buffer_base.gather_rows = recording_gather
    try:
        # rows for the bursts the trace below replays too; the graph writes them through the logger's counter,
        # which ``g_sampler`` keeps alive while the graph replays
        g_sampler, g_log = _logged(torch, sample_indices, (n + (1 + TRACE_TRIES) * UB_UPDATES, UB_BATCH))
        buffer.sample_indices = g_sampler
        trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(batch_size=UB_BATCH, verbose=False))
        walls, dev_ms, g_stats = [], [], []
        _zero_launches()
        for _ in range(calls):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            stats = trainer.update_burst(ts, bs, gen, UB_UPDATES)
            b.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            dev_ms.append(a.elapsed_time(b))
            g_stats.append({k: v.clone() for k, v in stats.items()})
        launches = _read_launches()
        buffer.sample_indices, e_log = _logged(torch, sample_indices, (n, UB_BATCH))
        t0 = time.perf_counter()
        e_stats = [algo.update(e_ts, buffer, bs, e_gen, UB_BATCH)[2] for _ in range(n)]
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    finally:
        buffer_base.gather_rows, buffer.sample_indices = real_gather, sample_indices
    torch.backends.cudnn.deterministic = deterministic

    burst = trainer.graph_pool.graphs[0]
    if len(trainer.graph_pool.graphs) != 1 or burst.replays != calls - 1:
        raise AssertionError(f"update_burst_pixels: programs {[(g.name, g.replays) for g in trainer.graph_pool.graphs]}")
    expect = {"gather_rows": 2 * n, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": 0}
    if launches != expect or burst.launches != {"gather_rows": 2 * UB_UPDATES}:
        raise AssertionError(f"update_burst_pixels: launches {launches} ({burst.launches} a replay) for {n} updates, "
                             f"expected {expect}")
    row_bytes = 84 * 84
    if shapes != {(4 * UB_BATCH, row_bytes)}:
        raise AssertionError(f"update_burst_pixels: gathers of (rows, row bytes) {sorted(shapes)}, expected "
                             f"{(4 * UB_BATCH, row_bytes)} only")
    if int((e_log < 0).sum()) or not torch.equal(g_log[:n], e_log):
        raise AssertionError("update_burst_pixels: the graph's sampled indices differ from the eager loop's")
    if torch.equal(g_log[n - 2 * UB_UPDATES:n - UB_UPDATES], g_log[n - UB_UPDATES:n]):
        raise AssertionError("update_burst_pixels: two replays drew the same indices")
    worst = 0.0
    for call in range(calls):
        for k, v in g_stats[call].items():
            want = torch.stack([s[k] for s in e_stats[call * UB_UPDATES:(call + 1) * UB_UPDATES]])
            worst = max(worst, float((v.double() - want.double()).abs().max()))
    for a, b in ((ts.model, e_ts.model), (ts.target, e_ts.target)):
        for x, y in zip(a.state_dict().values(), b.state_dict().values()):
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    for x, y in zip(_optimizer_state(ts), _optimizer_state(e_ts)):
        worst = max(worst, float((x.detach().double() - y.detach().double()).abs().max()))
    if worst > GRAPH_ATOL or not int(ts.step) == int(e_ts.step) == n:
        raise AssertionError(f"update_burst_pixels: graph against eager max |diff| {worst:.3e} (tolerance {GRAPH_ATOL}), "
                             f"steps {int(ts.step)} / {int(e_ts.step)} of {n}")
    if not all(bool(torch.isfinite(p).all()) for p in ts.model.parameters()) \
            or not bool(torch.isfinite(g_stats[-1]["loss"]).all()):
        raise AssertionError("update_burst_pixels: a non-finite weight or loss")
    if all(torch.equal(a, b) for a, b in zip(init, ts.model.parameters())):
        raise AssertionError("update_burst_pixels: training left the weights unchanged")

    # one gather at the burst's shape, on the run's own ring and rows, against src[idx]
    src, idx = first[0]
    got = gather.gather_rows(src, idx)
    if not torch.equal(got, src[idx]) or not torch.equal(got, gather.gather_rows_reference(src, idx)):
        raise AssertionError(f"gather_rows of {idx.numel()} rows of {row_bytes} B differs from src[idx]")
    kern, kern_e = _time_ms(lambda: gather.gather_rows(src, idx))
    plain = _time_ms(lambda: gather.gather_rows_reference(src, idx))[0]
    library = _time_ms(lambda: src[idx])[0]
    bound = (2 * idx.numel() * row_bytes + idx.numel() * idx.element_size()) / H100_HBM_BYTES_PER_S * 1e3
    gather_rec = {"shape": f"uint8{list(src.shape)} x {idx.numel()} rows", "ms": kern, "eager_ms": kern_e,
                  "plain_ms": plain, "library_ms": library, "bound_ms": bound, "bound_by": "bytes"}
    trace = _trace_burst(torch, trainer, ts, bs, gen, UB_UPDATES)

    wall, dev = statistics.median(walls[2:]), statistics.median(dev_ms[2:])
    tflops = UB_UPDATES * UB_BATCH * UB_FWD_FLOP * 4 / (dev / 1e3) / 1e12
    return launches, [
        f"update_burst_pixels path: E={E} ring uint8 {tuple(bs.data.obs.shape)} x2 ({bs.data.obs.numel() / 1e9:.3f} GB "
        f"each), prefill {UB_PREFILL} steps at eps 0.05 in {prefill_s:.2f} s; bursts of {UB_UPDATES} updates of batch "
        f"{UB_BATCH}, {calls} calls (eager warm-up {walls[0]:.2f} s, capture + replay {walls[1]:.2f} s, "
        f"{UB_ITERS} timed replays); gather_rows {launches['gather_rows']} = 2 per update, each of "
        f"{4 * UB_BATCH} rows of {row_bytes} B; cuDNN deterministic",
        f"update_burst_pixels path, graph against eager ({n} updates, the eager loop {eager_s:.2f} s): sampled indices "
        f"bit-identical; losses, weights, target and Adam state max |diff| {worst:.3e} (tolerance {GRAPH_ATOL})",
        f"update_burst_pixels path, replays: grad_steps_per_s {UB_UPDATES / wall:.1f} device_ms_per_grad_step "
        f"{dev / UB_UPDATES:.4f} (wall {wall / UB_UPDATES * 1e3:.4f}) samples_per_s {UB_UPDATES * UB_BATCH / wall:.1f}; "
        f"achieved CNN {tflops:.2f} TFLOP/s by bench.py's count ({UB_FWD_FLOP / 1e6:g} MFLOP a frame x 4 per sample, "
        f"over device time), {tflops * 1e12 / H100_BF16_OPS_PER_S:.4f} of the dense bf16 peak "
        f"{H100_BF16_OPS_PER_S / 1e12:.0f} TFLOP/s (H100 SXM data sheet, 700 W); graph pool "
        f"{trainer.graph_pool.memory_bytes() / 2**20:.1f} MiB; "
        f"last loss {float(g_stats[-1]['loss'][-1]):.5f} [{smi}]",
        f"update_burst_pixels path: " + trace,
        f"update_burst_pixels path, gather_rows at the burst's shape ({gather_rec['shape']}, the run's first rows): "
        f"bit-exact against src[idx]; kernel {kern * 1e3:.3f} us (CUDA graph) {kern_e * 1e3:.3f} (eager), plain "
        f"{plain * 1e3:.3f}, src[idx] {library * 1e3:.3f}, bound {bound * 1e3:.3f} us (bytes: 2 x {idx.numel()} x "
        f"{row_bytes} B + the indices over {H100_HBM_BYTES_PER_S / 1e12:.2f} TB/s), kernel at {bound / kern:.3f} of "
        f"the bound's rate [{smi}]",
    ], gather_rec


def _optimizer_state(ts) -> list:
    """Every tensor a step of the train state's optimizer (or optimizers) writes."""
    from tianshou_tpu_torch.algorithm.base import optimizer_tensors

    opts = ts.optim.values() if isinstance(ts.optim, dict) else [ts.optim]
    return [t for opt in opts for t in optimizer_tensors(opt)]


def test_chunk_check(torch, algo, coll, buffer, ts) -> str:
    """The test collector's chunk as the trainer's CUDA graph against the same chunk run eagerly:
    from one generator state and one reset each, ``GRAPH_CALLS`` chunks of ``TEST_CHUNK`` steps (the
    graph's first call is its eager warm-up, the second its capture and first replay, the third a
    replay). After every chunk the active mask, the episode count and the emitted ``done``, returns
    and lengths must be bit-identical, and the collect state at the end. Returns a report line."""
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tc = make_test_collector(algo)
    trainer = OffPolicyTrainer(algo, coll, tc, buffer, OffPolicyTrainerParams(verbose=False))
    sides = {}
    for side in ("graph", "eager"):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        state = tc.reset_episodes(gen, TEST_EPISODES)
        calls = []
        for _ in range(GRAPH_CALLS):
            if side == "graph":
                out = trainer.test_chunk(ts, state, gen, TEST_CHUNK)
            else:
                out = tc.episode_chunk(ts, state, gen, TEST_CHUNK)
            calls.append((out.map(torch.clone), state.active.clone(), state.n_done.clone()))
        torch.cuda.synchronize()
        sides[side] = (calls, _leaves(state.cstate))
    torch.backends.cudnn.deterministic = deterministic
    (g_calls, g_cs), (e_calls, e_cs) = sides["graph"], sides["eager"]
    for i, ((g_out, g_act, g_n), (e_out, e_act, e_n)) in enumerate(zip(g_calls, e_calls)):
        same = torch.equal(g_act, e_act) and torch.equal(g_n, e_n)
        if not same or not all(torch.equal(g_out[k], e_out[k]) for k in ("done", "ep_ret", "ep_len")):
            raise AssertionError(f"graph phase dqn test chunk {i}: the graph differs from the eager chunk")
    if not all(torch.equal(a, b) for a, b in zip(g_cs, e_cs)):
        raise AssertionError("graph phase dqn test chunk: the collect states differ")
    graph = trainer.graph_pool.graphs[0]
    n_done, active = int(g_calls[-1][2]), int(g_calls[-1][1].sum())
    if graph.replays != GRAPH_CALLS - 1 or n_done == 0 or active == TEST_E:
        raise AssertionError(f"graph phase dqn test chunk: {graph.replays} replays, {n_done} episodes counted, "
                             f"{active} envs still active")
    done = g_calls[-1][0]["done"]
    return (f"graph phase dqn test chunk, graph against eager: {GRAPH_CALLS} chunks of {TEST_CHUNK} steps over "
            f"{TEST_E} envs (eps_inference {TEST_EPS}); active mask ({active} of {TEST_E} active at the end), episode "
            f"count ({n_done}), emitted done, returns and lengths and the collect state bit-identical; returns of the "
            f"last chunk {g_calls[-1][0]['ep_ret'][done].tolist()}; replays {graph.replays}, capture {graph.capture_s:.2f} s")


def adam_check(torch, factory, params) -> str:
    """The optimizer ``factory`` builds for parameters on the card (capturable Adam), stepped
    ``ADAM_STEPS`` times through one CUDA graph (its first call eager, its second the capture),
    against what it builds for CPU copies of ``params`` (Adam as before the graphs), with the same
    gradients drawn from ``SEED``. Raises unless every parameter is within ``ADAM_ATOL`` and
    ``ADAM_SHARE`` of them within ``ADAM_CLOSE``; returns a report line."""
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    cuda = [torch.nn.Parameter(p.detach().float().clone()) for p in params]
    cpu = [torch.nn.Parameter(p.detach().float().cpu().clone()) for p in params]
    opt_cuda, opt_cpu = factory.create(cuda), factory.create(cpu)
    if not opt_cuda.defaults.get("capturable") or opt_cpu.defaults.get("capturable"):
        raise AssertionError("Adam: capturable must hold on the card's parameters and only there")
    gen = torch.Generator().manual_seed(SEED)
    for p in cuda:
        p.grad = torch.zeros_like(p)
    program = Graphed(lambda: factory.step(opt_cuda), GraphPool("cuda"), name="adam")
    for _ in range(ADAM_STEPS):
        grads = [torch.randn(p.shape, generator=gen) * 1e-2 for p in cpu]
        for p, g in zip(cuda, grads):
            p.grad.copy_(g)
        program()
        for p, g in zip(cpu, grads):
            p.grad = g
        factory.step(opt_cpu)
    diff = torch.cat([(a.detach().cpu() - b.detach()).abs().flatten() for a, b in zip(cuda, cpu)])
    moved = max(float((a.detach().cpu() - p.detach().float().cpu()).abs().max()) for a, p in zip(cpu, params))
    worst, close = float(diff.max()), float((diff <= ADAM_CLOSE).double().mean())
    if program.replays != ADAM_STEPS - 1 or moved == 0.0:
        raise AssertionError(f"Adam: {program.replays} replays, parameters moved by {moved}")
    if worst > ADAM_ATOL or close < ADAM_SHARE:
        raise AssertionError(f"Adam: capturable on the card against the CPU: max |diff| {worst:.3e} "
                             f"(tolerance {ADAM_ATOL}), {close:.5f} within {ADAM_CLOSE} (need {ADAM_SHARE})")
    return (f"capturable Adam on the card (one graph, {ADAM_STEPS} steps) against Adam on the CPU, "
            f"{diff.numel()} parameters: max |diff| {worst:.3e} (tolerance {ADAM_ATOL}), {close:.6f} within "
            f"{ADAM_CLOSE} (need {ADAM_SHARE}); largest move {moved:.3e}")


def _leaves(tree) -> list:
    from tianshou_tpu_torch.utils.tree import tree_map

    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


# ---------------------------------------------------------------------------
# CartPole: the first paths of the port that train to a score
# ---------------------------------------------------------------------------
def run_cartpole(torch, prio: bool, max_epochs: int = CP_EPOCHS, stop: bool = True):
    """DQN on CartPole as ``tests/test_dqn.py:17-48`` trains it, on the card, through the graphed
    trainer with its test phase: returns (result, trainer, test phases' CollectStats, the episode
    counts that the train collector's ``on_episode_done_hook`` saw, one per collect)."""
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.mlp import Net
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    torch.manual_seed(SEED)
    env = CartPole()
    algo = DQN(model=Net((64, 64), 2, input_dim=4), action_space=env.action_space,
               optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=3, target_update_freq=320,
               eps_training=0.3)
    ts = algo.init("cuda")
    buffer = (PrioritizedVectorReplayBuffer(20000, CP_E, alpha=0.6, beta=0.4) if prio
              else VectorReplayBuffer(20000, CP_E))
    bs = buffer.init(Batch(obs=torch.zeros(4), act=torch.tensor(0), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False), obs_next=torch.zeros(4)),
                     device="cuda")
    hooked, tests = [], []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    train_c = DeviceCollector(VectorDeviceEnv(env, CP_E, device="cuda"), algo, buffer,
                              on_episode_done_hook=lambda st: hooked.append(st.n_collected_episodes))
    test_c = DeviceCollector(VectorDeviceEnv(env, CP_E, device="cuda"), algo, None)
    params = OffPolicyTrainerParams(
        max_epochs=max_epochs, epoch_num_steps=CP_EPOCH_STEPS, test_step_num_episodes=10, batch_size=64,
        collection_step_num_env_steps=CP_T, update_per_step=0.1, start_steps=CP_PREFILL,
        stop_fn=(lambda r: r >= CP_THRESHOLD) if stop else None, compute_score_fn=score,
        train_fn=lambda epoch, step: {"eps_training": max(0.1, 0.3 * (1 - step / 30000))}, verbose=False,
    )
    trainer = OffPolicyTrainer(algo, train_c, test_c, buffer, params)
    res = trainer.run(ts, bs, torch.Generator(device="cuda").manual_seed(SEED))
    return res, trainer, tests, hooked


def cartpole_path(torch, prio: bool):
    """The CartPole path over uniform (``prio=False``) or prioritized replay: it must reach the
    threshold, the hook must fire once per collect chunk under the graphs, and the kernels must run as
    often as the path needs them. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree

    name = "cartpole_per" if prio else "cartpole"
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res, trainer, tests, hooked = run_cartpole(torch, prio)
    launches = _launches(gather, sumtree, physics_fused)
    if not res.best_reward >= CP_THRESHOLD:
        raise AssertionError(f"{name} path: best test reward {res.best_reward} after {res.epochs} epochs, "
                             f"below the threshold {CP_THRESHOLD}")
    vector_steps = res.env_step // CP_E  # one buffer add per vector step, prefill included
    if len(hooked) != res.env_step // (CP_T * CP_E):
        raise AssertionError(f"{name} path: on_episode_done_hook ran {len(hooked)} times for "
                             f"{res.env_step // (CP_T * CP_E)} collect chunks")
    expect = {"gather_rows": 0, "prefix_sum_idx": res.gradient_step if prio else 0,
              "tree_update": res.gradient_step + vector_steps if prio else 0, "physics_fused": 0}
    if launches != expect:
        raise AssertionError(f"{name} path: kernel launches {launches}, expected {expect}")
    if len(tests) != res.epochs or any(t.n_collected_episodes != 10 for t in tests):
        raise AssertionError(f"{name} path: {len(tests)} test phases for {res.epochs} epochs")
    graphs = {g.name.split()[0]: g for g in trainer.graph_pool.graphs}
    if sorted(graphs) != ["collect_chunk", "test_chunk", "update_burst"]:
        raise AssertionError(f"{name} path: programs {sorted(graphs)}")
    t = res.timing
    train_steps = res.env_step - CP_PREFILL
    chunks = sum(s.n_collected_steps for s in tests) // (TEST_CHUNK * CP_E)
    lines = [
        f"{name} path: best test reward {res.best_reward:.1f} (threshold {CP_THRESHOLD}) after {res.epochs} epochs; "
        f"env_steps {res.env_step} (prefill {CP_PREFILL}) gradient_steps {res.gradient_step}; wall {res.train_time:.2f} s "
        f"(prefill {t['prefill']:.2f}, collect {t['collect']:.2f}, update {t['update']:.2f}, test {t['test']:.2f}); "
        f"train env_steps_per_s {train_steps / (t['collect'] + t['update']):.1f} (collect and update time only; "
        f"{train_steps / (t['collect'] + t['update'] - graphs['collect_chunk'].capture_s - graphs['update_burst'].capture_s):.1f} "
        f"without the two programs' capture time); "
        f"test reward by epoch {[round(float(s.returns.mean()), 1) for s in tests]}",
        f"{name} path, test phase: {len(tests)} phases, {chunks} chunks of {TEST_CHUNK} steps over {CP_E} envs, "
        f"{t['test']:.3f} s = {t['test'] / res.train_time:.3f} of the wall time; capture s "
        f"{ {n: round(g.capture_s, 3) for n, g in graphs.items()} }; on_episode_done_hook once per collect chunk "
        f"({len(hooked)}); launches {launches}",
    ]
    return launches, lines


def determinism_phase(torch) -> list[str]:
    """The uniform CartPole path twice for ``DET_EPOCHS`` epochs from seed 0 (no stop) under
    ``TraceLoggerContext``: the traces (``collector`` and ``trainer/collect`` lines, and a ``trainer/update``
    line with the hash of the weights after every burst) must be equal line for line
    (``TraceDeterminismTest`` in a temporary directory). cuDNN is held to deterministic algorithms
    (``torch.backends.cudnn.deterministic``) for the phase; nothing else is set."""
    from tianshou_tpu_torch.utils.determinism import TraceDeterminismTest, TraceLoggerContext

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    traces, results = [], []
    for _ in range(2):
        with TraceLoggerContext() as tl:
            results.append(run_cartpole(torch, prio=False, max_epochs=DET_EPOCHS, stop=False)[0])
            traces.append(tl.get_trace())
    torch.backends.cudnn.deterministic = deterministic
    with tempfile.TemporaryDirectory() as d:
        det = TraceDeterminismTest(d)
        det.check("cartpole", traces[0])
        det.check("cartpole", traces[1], create_if_missing=False)  # raises at the first lines that differ
    hashes = [line for line in traces[0] if line.startswith("trainer/update")]
    if not hashes or any(r.epochs != DET_EPOCHS for r in results):
        raise AssertionError("determinism phase: no parameter hash traced, or a run stopped early")
    return [f"determinism phase: two runs of the uniform CartPole path, {DET_EPOCHS} epochs from seed {SEED}, "
            f"cudnn.deterministic=True: {len(traces[0])} trace lines ({len(hashes)} parameter hashes) identical "
            f"line for line; last {hashes[-1]}; test rewards {results[0].best_reward:.1f} and {results[1].best_reward:.1f}"]


# ---------------------------------------------------------------------------
# physics: the fused step kernel and the bench_physics_step paths
# ---------------------------------------------------------------------------
def physics_flops(model, contacts, limits, n_substeps: int, penalty: bool = False) -> float:
    """Float32 operations (a multiply and an add count one each) of ``n_substeps`` substeps of
    the algorithm as ``csrc/physics_fused.cu`` writes it, summed over envs, with ``contacts`` and
    ``limits`` the per-env counts of active contact spheres and joint limits: recursive body
    kinematics, each body's composite inertia and wrench over its subtree, the mass matrix an
    entry at a time from them (where one dof lies below the other), two Cholesky factorizations
    with their right-hand sides (the first only with an active row),
    and the QP over the active rows (with its matrix up to 16 rows, without beyond). A sum that
    every lane repeats for itself (a column's pivot) is counted once. Under the ``penalty`` model
    there is no QP and one factorization; every contact sphere's spring-damper and friction (its
    point, velocity, forces and torque: about 64) and every limit's spring (about 12) are counted
    whatever the state."""
    from tianshou_tpu_torch.env.physics.model import FREE, SLIDE

    nq, nb, nl = model.nq, model.nbody, len(model.limit_q_idx)
    iters = int(model.contact_iterations)
    cross, point_accel, mv, mm = 9, 33, 15, 45

    below = [{b} for b in range(nb)]  # bodies of each body's subtree
    for b in range(nb - 1, 0, -1):
        if model.parent[b] >= 0:
            below[model.parent[b]] |= below[b]
    kin = 0.0
    sub = {}  # dof -> the bodies it moves
    for b in range(nb):
        joints = model.joints_of(b)
        if joints and joints[0].jtype == FREE:
            kin += 650 + 700 + 5 * mm  # second-order jet and first-order duals of the exp map, five vee(A B^T)
            for m in range(6):
                sub[joints[0].q_idx + m] = below[b]
        else:
            if model.parent[b] >= 0:
                kin += mv + mm + cross + point_accel + 9
            for j in joints:
                sub[j.q_idx] = below[b]
                kin += (mv + cross + point_accel + 33) if j.jtype == SLIDE else (
                    3 * mv + 3 * cross + 2 * point_accel + 2 * mm + 36 + 40 + 27)  # two products, Rodrigues, sincos
        kin += mv + cross + point_accel + 6  # origin -> centre of mass
    wrench = nb * (2 * mm + 2 * mv + 24 + (80 if model.fluid_density > 0 or model.fluid_viscosity > 0 else 0))
    composite = 48 * sum(len(v) for v in below)
    related = sum(1 for i in range(nq) for k in range(i + 1) if sub[i] <= sub[k] or sub[k] <= sub[i])
    mass_and_force = 70 * related + 24 * nq  # two twists, a momentum and a pairing per entry
    chol, solve = nq ** 3 / 3, nq * nq
    factor = chol + solve
    fixed = kin + wrench + composite + mass_and_force + factor + 2 * nq * nq + 2 * nq + solve + 2 * nq
    if penalty:
        per_env = fixed + 64 * len(model.contact_radius) + 12 * nl
        return float(per_env * contacts.numel()) * n_substeps
    c, l = contacts.double(), limits.double()
    na = 4 * c + l
    fixed = fixed + (na > 0).double() * (factor + 2 * nq + nl * (solve + 5 * nq + 60))  # skipped when no row is active
    rows = c * (3 * (8 * nq + solve) + 2 * mv + 140 + 2 * nq + 8 * nq)
    per_iteration = na * (2 * na + 8) * (na <= 16).double() + na * (4 * nq + 8) * (na > 16).double()
    qp = na * na * 2 * nq + na * 2 * nq + iters * per_iteration + na * 2 * nq + solve
    per_env = fixed + rows + qp
    return float(per_env.sum()) * n_substeps


def _inside(torch, got, want):
    """Per env: both q and qd within the tolerances."""
    (q, qd), (rq, rqd) = got, want
    ok_q = (q - rq).abs() <= Q_TOL + Q_TOL * rq.abs()
    ok_qd = (qd - rqd).abs() <= QD_TOL + QD_TOL * rqd.abs()
    return ok_q.all(1) & ok_qd.all(1)


def _eager_ms(torch, fn, runs: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _springs_active(torch, model, q) -> tuple[int, int]:
    """(sphere-env pairs below the floor, dof-env pairs past a limit) at ``q``: the penalty model's springs."""
    from tianshou_tpu_torch.env.physics import dynamics

    pen = 0
    if len(model.contact_radius):
        p, R = dynamics.forward_kinematics(model, q)
        cb = torch.as_tensor(model.contact_body, dtype=torch.int64, device=q.device)
        off = torch.as_tensor(model.contact_offset, dtype=torch.float32, device=q.device)
        z = p[:, cb, 2] + (R[:, cb, 2] * off).sum(-1)
        pen = int((z < torch.as_tensor(model.contact_radius, dtype=torch.float32, device=q.device)).sum())
    past = 0
    if len(model.limit_q_idx):
        ql = q[:, torch.as_tensor(model.limit_q_idx, dtype=torch.int64, device=q.device)]
        lo, hi = (torch.as_tensor(model.limit_range[:, i], dtype=torch.float32, device=q.device) for i in (0, 1))
        past = int(((ql < lo) | (ql > hi)).sum())
    return pen, past


def penalty_checks(torch, pf, task: str) -> tuple[dict, list[str], float]:
    """The penalty branch of the kernel (``contact_model="penalty"``, its own library) against the plain
    version for ``task``: near home at E = 2048, 32 and 10, every env inside the tolerances; states pushed
    into the floor and past joint limits (``PEN_DROP``, noise ``PEN_SCALE``) at E = 2048, where the springs
    must act and at least ``MIN_SHARE_INSIDE`` of envs be inside; timed there beside the bound of the
    penalty model's operations. Returns (times, report lines, max |err| over the envs inside)."""
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.env.physics import dynamics

    env = make(task)
    model, fs = env.model, env.frame_skip
    model.contact_model = "penalty"
    if not pf.uses_penalty(model) or pf.build_target(model)[1][-1] != ("TT_PENALTY", 1):
        raise AssertionError(f"physics_fused {task}: the penalty model does not select the penalty library")
    n_sub = fs * dynamics.resolve_substeps(model, env.substeps)
    nu = len(model.actuators)
    g = torch.Generator(device="cuda").manual_seed(5)
    home = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")
    lines, max_err = [], 0.0

    def both(q, qd, ctrl):
        before = pf.launch_count()
        got = pf.fused_step(model, q, qd, ctrl, frame_skip=fs)
        want = pf.fused_step_reference(model, q, qd, ctrl, frame_skip=fs)
        torch.cuda.synchronize()
        if pf.launch_count() != before + 1:
            raise AssertionError(f"physics_fused penalty {task}: the kernel did not launch")
        if not all(bool(torch.isfinite(x).all()) for x in (*got, *want)):
            raise AssertionError(f"physics_fused penalty {task}: a non-finite output")
        ok = _inside(torch, got, want)
        err = max(float(torch.where(ok[:, None], got[i] - want[i], 0.0).abs().max()) for i in (0, 1))
        return got, want, ok, err

    for E in (PHYS_E, OFF_E, OFF_TEST_E):
        q = home + 0.03 * torch.randn(E, model.nq, device="cuda", generator=g)
        qd = 0.05 * torch.randn(E, model.nq, device="cuda", generator=g)
        got, want, ok, err = both(q, qd, torch.rand(E, nu, device="cuda", generator=g) * 2 - 1)
        if not bool(ok.all()):
            raise AssertionError(f"physics_fused penalty {task} E={E} near home: {int((~ok).sum())} envs outside")
        max_err = max(max_err, err)
        lines.append(f"physics_fused penalty {task} E={E} near home: all envs inside q {Q_TOL} qd {QD_TOL}, max |err| {err:.3e}")
    q = home + PEN_SCALE * torch.randn(PHYS_E, model.nq, device="cuda", generator=g)
    if task in PEN_DROP:
        q[:, PEN_DROP[task][0]] -= PEN_DROP[task][1]
    if len(model.limit_q_idx):  # the first limited dof 0.05 past its range, above in even envs, below in odd
        lo, hi = model.limit_range[0]
        q[0::2, model.limit_q_idx[0]] = hi + 0.05
        q[1::2, model.limit_q_idx[0]] = lo - 0.05
    qd = 0.5 * torch.randn(PHYS_E, model.nq, device="cuda", generator=g)
    ctrl = torch.rand(PHYS_E, nu, device="cuda", generator=g) * 2 - 1
    pen, past = _springs_active(torch, model, q)
    if (len(model.contact_radius) and pen == 0) or (len(model.limit_q_idx) and past == 0):
        raise AssertionError(f"physics_fused penalty {task}: pushed states leave the springs idle ({pen}, {past})")
    got, want, ok, err = both(q, qd, ctrl)
    share = float(ok.double().mean())
    if share < MIN_SHARE_INSIDE:
        raise AssertionError(f"physics_fused penalty {task} pushed states: only {share:.5f} of envs inside")
    max_err = max(max_err, err)
    lines.append(f"physics_fused penalty {task} E={PHYS_E} pushed states: {pen} spheres below the floor, {past} dofs past "
                 f"a limit; {int((~ok).sum())} of {PHYS_E} envs outside (share inside {share:.5f}), max |err| inside "
                 f"{err:.3e}")
    kern, kern_e = _time_ms(lambda: pf.fused_step(model, q, qd, ctrl, frame_skip=fs), warmup=2, runs=30, per_graph=3)
    plain_e = _eager_ms(torch, lambda: pf.fused_step_reference(model, q, qd, ctrl, frame_skip=fs))
    zeros = torch.zeros(PHYS_E)  # the penalty model's work does not depend on the active rows
    flops = physics_flops(model, zeros, zeros, n_sub, penalty=True)
    by_ops = flops / H100_FP32_OPS_PER_S * 1e3
    by_bytes = PHYS_E * (4 * model.nq + nu) * 4 / H100_HBM_BYTES_PER_S * 1e3
    times = {"ms": kern, "eager_ms": kern_e, "plain_ms": plain_e, "bound_ms": max(by_ops, by_bytes),
             "bound_by": "operations" if by_ops >= by_bytes else "bytes", "gflop": flops / 1e9, "substeps": n_sub,
             **pf.kernel_info(model)}
    lines.append(f"physics_fused penalty {task} E={PHYS_E} x {n_sub} substeps, ms per vector step: kernel {kern:.4f} "
                 f"(CUDA graph) {kern_e:.4f} (eager); plain {plain_e:.2f} (eager); bound {times['bound_ms']:.5f} "
                 f"({flops / 1e9:.3f} GFLOP; by bytes {by_bytes:.6f}); kernel at {times['bound_ms'] / kern:.4f} of the "
                 f"bound's rate")
    return times, lines, max_err


def physics_phase(torch, pf) -> tuple[list[dict], list[str]]:
    """The fused step kernel against the plain version on the card for every task, and its
    times beside the bound. Returns ([JSON record without launches], report lines); the record's
    numbers are HalfCheetah's at E = 2048 on a rollout state, the main path's shape."""
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.env.physics import dynamics

    lines, by_task, by_task_penalty = [], {}, {}
    max_err = pen_max_err = 0.0
    for task in PHYS_TASKS:
        env = make(task)
        model, fs = env.model, env.frame_skip
        n_sub = fs * dynamics.resolve_substeps(model, env.substeps)
        nu = len(model.actuators)
        g = torch.Generator(device="cuda").manual_seed(3)
        home = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")

        def near_home(E):
            q = home + 0.03 * torch.randn(E, model.nq, device="cuda", generator=g)
            qd = 0.05 * torch.randn(E, model.nq, device="cuda", generator=g)
            return q, qd, torch.rand(E, nu, device="cuda", generator=g) * 2 - 1

        def both(q, qd, ctrl):
            got = pf.fused_step(model, q, qd, ctrl, frame_skip=fs)
            want = pf.fused_step_reference(model, q, qd, ctrl, frame_skip=fs)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(x).all()) for x in (*got, *want)):
                raise AssertionError(f"physics_fused {task}: a non-finite output")
            return got, want, _inside(torch, got, want)

        # (a) near home: every env inside
        # OFF_E and OFF_TEST_E: the off-policy paths' train and test envs (10 fills a block partly)
        for E in (PHYS_E, OFF_E, OFF_TEST_E) + ((6, PHYS_E + 5) if task == "HalfCheetah" else ()):
            q, qd, ctrl = near_home(E)
            got, want, ok = both(q, qd, ctrl)
            err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
            max_err = max(max_err, err) if task == "HalfCheetah" else max_err
            if not bool(ok.all()):
                raise AssertionError(f"physics_fused {task} E={E} near home: {int((~ok).sum())} envs outside the tolerance")
            lines.append(f"physics_fused {task} E={E} near home: all envs inside q {Q_TOL} qd {QD_TOL}, "
                         f"max |dq| {float((got[0] - want[0]).abs().max()):.3e} max |dqd| {float((got[1] - want[1]).abs().max()):.3e}")
        # TR_E: the trust-region and PPO example paths' train envs, on a generator of its own (the draws above stay)
        g_tr = torch.Generator(device="cuda").manual_seed(4)
        q = home + 0.03 * torch.randn(TR_E, model.nq, device="cuda", generator=g_tr)
        qd = 0.05 * torch.randn(TR_E, model.nq, device="cuda", generator=g_tr)
        got, want, ok = both(q, qd, torch.rand(TR_E, nu, device="cuda", generator=g_tr) * 2 - 1)
        if not bool(ok.all()):
            raise AssertionError(f"physics_fused {task} E={TR_E} near home: {int((~ok).sum())} envs outside the tolerance")
        lines.append(f"physics_fused {task} E={TR_E} near home: all envs inside q {Q_TOL} qd {QD_TOL}, "
                     f"max |dq| {float((got[0] - want[0]).abs().max()):.3e} max |dqd| {float((got[1] - want[1]).abs().max()):.3e}")
        if task == "Ant":  # rotation vectors beyond pi: the re-chart runs inside the kernel
            q, qd, ctrl = near_home(PHYS_E)
            axis = torch.randn(PHYS_E, 3, device="cuda", generator=g)
            norm = 3.0 + 0.6 * torch.rand(PHYS_E, 1, device="cuda", generator=g)
            q[:, 3:6] = axis / axis.norm(dim=1, keepdim=True) * norm
            q[:, 2] += 0.5
            got, want, ok = both(q.contiguous(), qd, ctrl)
            n_rechart = int(((got[0][:, 3:6] * q[:, 3:6]).sum(1) < 0).sum())  # r -> r (1 - 2 pi / |r|) flips r
            if not bool(ok.all()) or n_rechart == 0:
                raise AssertionError(f"physics_fused Ant re-chart: {int((~ok).sum())} envs outside, {n_rechart} re-charted")
            lines.append(f"physics_fused Ant E={PHYS_E} rotation vectors of norm 3.0-3.6: {n_rechart} envs re-charted, all inside")

        # (b) the kernel's own random-action rollout: one further step by both at some steps
        q, qd, ctrl = near_home(PHYS_E)
        timing_state = None
        for step in range(1, max(ROLLOUT_CHECKS) + 1):
            q, qd = pf.fused_step(model, q, qd, ctrl, frame_skip=fs)
            ctrl = torch.rand(PHYS_E, nu, device="cuda", generator=g) * 2 - 1
            if step in ROLLOUT_CHECKS:
                got, want, ok = both(q, qd, ctrl)
                share = float(ok.double().mean())
                contacts, limits = dynamics.active_rows(model, q)
                lines.append(
                    f"physics_fused {task} rollout step {step}: {int((~ok).sum())} of {PHYS_E} envs outside "
                    f"(share inside {share:.5f}), worst |dq| {float((got[0] - want[0]).abs().max()):.3e} "
                    f"|dqd| {float((got[1] - want[1]).abs().max()):.3e}, active contacts per env "
                    f"{float(contacts.double().mean()):.2f} limits {float(limits.double().mean()):.2f}")
                if share < MIN_SHARE_INSIDE:
                    raise AssertionError(f"physics_fused {task} rollout step {step}: only {share:.5f} of envs inside")
                if task == "HalfCheetah":
                    max_err = max(max_err, float((got[0] - want[0])[ok].abs().max()), float((got[1] - want[1])[ok].abs().max()))
                if step == 32:
                    timing_state = (q.clone(), qd.clone(), ctrl.clone())
                    # the first rows of this state at the off-policy paths' E: against the plain version
                    # on the same rows, and bit for bit what the kernel gives those rows at E = PHYS_E
                    for n in (OFF_E, TR_E, OFF_TEST_E):
                        sub = [t[:n].contiguous() for t in (q, qd, ctrl)]
                        got_n, _, ok_n = both(*sub)
                        if not all(torch.equal(a, b[:n]) for a, b in zip(got_n, got)):
                            raise AssertionError(f"physics_fused {task} rollout step {step}, E={n}: the kernel's rows "
                                                 f"differ from its rows at E={PHYS_E}")
                        lines.append(f"physics_fused {task} rollout step {step}, E={n}: rows bit-identical to the "
                                     f"kernel's at E={PHYS_E}; {int(ok_n.sum())} of {n} envs inside against the plain "
                                     f"version at E={n} ({int(ok[:n].sum())} at E={PHYS_E})")

        # times at the rollout state of step 32, beside the bound for that state's active rows
        tq, tqd, tc = timing_state
        count = pf.launch_count()
        runs = 30
        kern, kern_e = _time_ms(lambda: pf.fused_step(model, tq, tqd, tc, frame_skip=fs), warmup=2, runs=runs, per_graph=3)
        if pf.launch_count() == count:
            raise AssertionError("the timed fused_step calls did not launch the kernel")
        by_envs = {PHYS_E: kern}  # latency-bound if 32 envs cost what 2048 do, throughput-bound if 8448 cost 4x
        for n_envs in (32, 8448):
            reps = -(-n_envs // PHYS_E)
            sq, sqd, sc = (t.repeat(reps, 1)[:n_envs].contiguous() for t in (tq, tqd, tc))
            by_envs[n_envs] = _time_ms(lambda: pf.fused_step(model, sq, sqd, sc, frame_skip=fs), warmup=2, runs=8, per_graph=3)[0]
        plain_e = _eager_ms(torch, lambda: pf.fused_step_reference(model, tq, tqd, tc, frame_skip=fs))
        contacts, limits = dynamics.active_rows(model, tq)
        flops = physics_flops(model, contacts, limits, n_sub)
        by_ops = flops / H100_FP32_OPS_PER_S * 1e3
        by_bytes = PHYS_E * (4 * model.nq + nu) * 4 / H100_HBM_BYTES_PER_S * 1e3
        by_task[task] = {"ms": kern, "eager_ms": kern_e, "plain_ms": plain_e, "bound_ms": max(by_ops, by_bytes),
                         "bound_by": "operations" if by_ops >= by_bytes else "bytes", "gflop": flops / 1e9,
                         "substeps": n_sub, "ms_by_envs": {str(k): v for k, v in sorted(by_envs.items())},
                         **pf.kernel_info(model)}
        lines.append(
            f"physics_fused {task} E={PHYS_E} x {n_sub} substeps, ms per vector step: kernel {kern:.4f} (CUDA graph) "
            f"{kern_e:.4f} (eager); plain {plain_e:.2f} (eager); bound {max(by_ops, by_bytes):.5f} "
            f"({flops / 1e9:.3f} GFLOP at {H100_FP32_OPS_PER_S / 1e12:.0f} TFLOP/s; by bytes {by_bytes:.6f}); "
            f"kernel at {max(by_ops, by_bytes) / kern:.4f} of the bound's rate; kernel (CUDA graph) at E=32 "
            f"{by_envs[32]:.4f}, E=8448 {by_envs[8448]:.4f}")
        pen_times, pen_lines, pen_err = penalty_checks(torch, pf, task)
        by_task_penalty[task] = pen_times
        lines += pen_lines
        pen_max_err = max(pen_max_err, pen_err) if task == PEN_PATH[0] else pen_max_err

    main, pen = by_task["HalfCheetah"], by_task_penalty[PEN_PATH[0]]
    record = {
        "name": "physics_fused", "route": "cuda",
        "source": "tianshou_tpu_torch/ops/kernels/csrc/physics_fused.cu",
        "replaces": "tianshou_tpu/ops/pallas/physics_fused.py:67",
        "max_abs_err": max_err, "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None, "plain_timing": "eager", "by_task": by_task,
        # the contact_model="penalty" branch (-DTT_PENALTY=1), on the physics_penalty_halfcheetah path's shape
        "penalty": {"max_abs_err": pen_max_err, "ms": pen["ms"], "plain_ms": pen["plain_ms"], "bound_ms": pen["bound_ms"],
                    "bound_by": pen["bound_by"], "library_ms": None, "by_task": by_task_penalty},
    }
    return [record], lines


def rollout_program(torch, venv, steps: int, gen, healthy_z: tuple[float, float] | None = None, checks: bool = False):
    """``bench.py:bench_physics_step`` in the port: ``(state, program, sums)``, where ``program()`` runs
    ``steps`` vector steps of ``venv`` from ``state`` (its reset state) with actions from
    ``action_space.sample`` and writes the last state back into ``state``, as ONE program, the
    counterpart of the bench's jitted scan, through the graph helper: its first call is its eager
    warm-up, the second its capture and first replay, later calls replay. With ``checks`` the program
    also accumulates on the device, in ``sums``: ``finite`` (every state, observation and reward so
    far), ``terminated`` (the count of terminated reports) and, with ``healthy_z``, ``wrong_term``
    (envs whose terminated flag disagrees with lo < z < hi). Without, ``sums`` is empty."""
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool
    from tianshou_tpu_torch.utils.tree import tree_map

    state, obs = tree_map(torch.clone, venv.reset(gen))
    sums = {}
    if checks:
        zero = torch.zeros((), dtype=torch.int64, device=obs.device)
        sums = {"finite": torch.isfinite(obs).all(), "terminated": zero.clone(), "wrong_term": zero.clone()}

    def rollout():
        s = state
        for _ in range(steps):
            out = venv.step(s, venv.action_space.sample(venv.num_envs, gen, venv.device), gen)
            s = out.state
            if checks:
                sums["finite"].logical_and_(torch.isfinite(s.q).all() & torch.isfinite(s.qd).all()
                                            & torch.isfinite(out.obs).all() & torch.isfinite(out.reward).all())
                sums["terminated"].add_(out.terminated.sum())
                if healthy_z is not None:
                    z = s.q[:, 2]
                    sums["wrong_term"].add_((out.terminated != ~((z > healthy_z[0]) & (z < healthy_z[1]))).sum())
        tree_map(torch.Tensor.copy_, state, s)
        return out

    return state, Graphed(rollout, GraphPool(venv.device), (gen,), name="rollout"), sums


def physics_path(torch, task: str, steps: int, penalty: bool = False):
    """The physics path of ``task``: ``rollout_program`` called three times (eager warm-up, capture
    and first replay, replay, which is timed); with ``penalty``, under ``contact_model="penalty"`` set on
    the env's model after construction, so that the kernel's penalty library runs. Returns ({kernel:
    launches} over the three calls, report lines)."""
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree

    venv = VectorDeviceEnv(make(task), PHYS_E, device="cuda")
    if penalty:
        venv.env.model.contact_model = "penalty"
        task = f"{task} penalty"
        if not physics_fused.uses_penalty(venv.env.model):
            raise AssertionError(f"{task} physics path: the model does not step under the penalty model")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    # Ant-v4's healthy range: a terminated env is one outside 0.2 < z < 1.0
    state, program, sums = rollout_program(torch, venv, steps, gen, (0.2, 1.0) if task == "Ant" else None, checks=True)
    pool = program.pool
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = program()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = _launches(gather, sumtree, physics_fused)
    total = 3 * steps
    if launches != {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": total}:
        raise AssertionError(f"{task} physics path: kernel launches {launches} for {total} steps")
    if program.replays != 2 or program.launches != {"physics_fused": steps}:
        raise AssertionError(f"{task} physics path: {program.replays} replays of {program.launches}")
    if not bool(sums["finite"]):
        raise AssertionError(f"{task} physics path: a non-finite state, observation or reward")
    obs_dim = venv.observation_space.shape[0]
    if out.obs.shape != (PHYS_E, obs_dim) or out.obs.device.type != "cuda" or out.reward.shape != (PHYS_E,):
        raise AssertionError(f"{task} physics path: observation {tuple(out.obs.shape)} reward {tuple(out.reward.shape)}")
    if state.t.min().item() != total or state.t.max().item() != total:
        raise AssertionError(f"{task} physics path: t is {state.t.min().item()}..{state.t.max().item()}, expected {total}")
    if int(sums["wrong_term"]) != 0:
        raise AssertionError(f"{task} physics path: {int(sums['wrong_term'])} envs' terminated flag disagrees with 0.2 < z < 1.0")
    if penalty:
        info = physics_fused.kernel_info(venv.env.model)
        task += f" (library for {physics_fused.build_target(venv.env.model)[1][-1]}, {info['shared_bytes_per_env']} B per env)"
    lines = [
        f"{task} physics path: E={PHYS_E} T={steps} x 3 calls (eager warm-up, capture + replay, replay) obs "
        f"{tuple(out.obs.shape)} physics_fused launches {launches['physics_fused']} (1 per vector step); graph replay: "
        f"env_steps_per_s {steps * PHYS_E / walls[2]:.1f} us_per_vector_step {walls[2] / steps * 1e6:.1f} (eager warm-up "
        f"{walls[0] / steps * 1e6:.1f}); {_graph_report(pool, 1)}; terminated reports {int(sums['terminated'])} mean reward last "
        f"step {float(out.reward.mean()):.4f}"
    ]
    return launches, lines


def humanoid_physics_path(torch):
    """``VectorDeviceEnv(Humanoid(), 2048)`` on the plain route (``dynamics.step`` with its 109 geom-pair
    rows; neither package has a kernel for it): ``rollout_program`` of ``HUM_T`` random-action steps (the
    depth cut from 64) called three times, the third timed; no kernel launch, finite states. Then the
    graph against the eager loop: ``HUM_T`` steps of fixed actions from one state, once run eagerly and once
    replayed from a captured graph, bit-identical. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.env.physics import dynamics
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool
    from tianshou_tpu_torch.utils.tree import tree_map

    venv = VectorDeviceEnv(make("Humanoid"), PHYS_E, device="cuda")
    model = venv.env.model
    if venv.env.physics_route != "plain" or not model.enable_pair_contacts:
        raise AssertionError(f"humanoid physics path: route {venv.env.physics_route}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    state, program, sums = rollout_program(torch, venv, HUM_T, gen, (1.0, 2.0), checks=True)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = program()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = _launches(gather, sumtree, physics_fused)
    if any(launches.values()) or program.replays != 2:
        raise AssertionError(f"humanoid physics path: launches {launches}, replays {program.replays}")
    if not bool(sums["finite"]) or int(sums["wrong_term"]) != 0 or out.obs.shape != (PHYS_E, 123):
        raise AssertionError(f"humanoid physics path: finite {bool(sums['finite'])}, wrong terminations "
                             f"{int(sums['wrong_term'])}, obs {tuple(out.obs.shape)}")
    contacts, limits = dynamics.active_rows(model, state.q)
    pair_rows = dynamics.active_pair_rows(model, state.q)

    # the graph against the eager loop, on fixed actions from one start state
    start = tree_map(torch.clone, state)
    acts = [venv.action_space.sample(PHYS_E, gen, venv.device) for _ in range(HUM_T)]
    st = tree_map(torch.clone, start)

    def fixed():
        s = st
        for a in acts:
            s = venv.step(s, a, gen).state
        tree_map(torch.Tensor.copy_, st, s)

    fixed_graph = Graphed(fixed, GraphPool(venv.device), (gen,), name="humanoid fixed")
    fixed_graph()  # eager
    eager = tree_map(torch.clone, st)
    tree_map(torch.Tensor.copy_, st, start)
    t0 = time.perf_counter()
    fixed_graph()  # capture and replay
    torch.cuda.synchronize()
    capture_replay = time.perf_counter() - t0
    diff = max(float((a.double() - b.double()).abs().max()) for a, b in zip((st.q, st.qd), (eager.q, eager.qd)))
    if not (torch.equal(st.q, eager.q) and torch.equal(st.qd, eager.qd) and torch.equal(st.t, eager.t)):
        raise AssertionError(f"humanoid physics path: the graph differs from the eager loop by {diff:.3e}")
    return launches, [
        f"humanoid physics path: E={PHYS_E} T={HUM_T} (depth cut from 64) x 3 calls on the plain route (dynamics.step, "
        f"{len(model.pair_body1)} candidate pair rows, no kernel in either package); launches {launches}; graph replay: "
        f"env_steps_per_s {HUM_T * PHYS_E / walls[2]:.1f} us_per_vector_step {walls[2] / HUM_T * 1e6:.1f} (eager warm-up "
        f"{walls[0] / HUM_T * 1e6:.1f}, capture + replay {walls[1] / HUM_T * 1e6:.1f}); {_graph_report(program.pool, 1)}; "
        f"active per env at the end: pair rows {float(pair_rows.double().mean()):.3f} (envs with any "
        f"{int((pair_rows > 0).sum())}), contacts {float(contacts.double().mean()):.2f}, limits "
        f"{float(limits.double().mean()):.2f}; terminated reports {int(sums['terminated'])}",
        f"humanoid physics path, graph against eager: {HUM_T} steps of fixed actions at E={PHYS_E}, q, qd and t "
        f"bit-identical, max |diff| {diff:.3e}; capture + replay {capture_replay:.2f} s",
    ]


# ---------------------------------------------------------------------------
# on-policy: PPO, A2C and REINFORCE trained on the device physics and on CartPole
# ---------------------------------------------------------------------------
def build_ppo(torch, task: str, num_envs: int, **kw):
    """``bench.py:bench_mujoco_ppo``'s algorithm on ``NormObs(task)`` in the port (``kw`` overrides
    its options; ``sde`` and ``sigma_init`` go to the actor): returns (algo, train state, collector)."""
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.env.wrappers import NormObs
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    torch.manual_seed(SEED)
    env = NormObs(make(task))
    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    ppo_init = kw.pop("ppo_init", False)
    actor_kw = {k: kw.pop(k) for k in ("sde", "sigma_init") if k in kw}
    opts = dict(optim=AdamOptimizerFactory(lr=kw.pop("lr", 3e-4), max_grad_norm=0.5), return_standardization=True,
                value_clip=True, **kw)
    algo = PPO(actor=ContinuousActorProbabilistic((64, 64), nu, ppo_init=ppo_init, input_dim=obs_dim, **actor_kw),
               critic=ContinuousCritic((64, 64), use_action=False, ppo_init=ppo_init, input_dim=obs_dim),
               action_space=env.action_space, **opts)
    ts = algo.init("cuda")
    return algo, ts, DeviceCollector(VectorDeviceEnv(env, num_envs, device="cuda"), algo, None)


def _adam_count(ts):
    return ts.optim.state[next(iter(ts.model.parameters()))]["step"]


def _onpolicy_tensors(torch, ts, cstate) -> list:
    """Every tensor an on-policy chunk writes: weights, Adam's state and rate, counters, statistics."""
    out = [*ts.model.parameters(), ts.step, *ts.extra.values(), *_leaves(cstate)]
    for group in ts.optim.param_groups:
        out += [v for p in group["params"] for v in ts.optim.state[p].values()]
        if torch.is_tensor(group["lr"]):
            out.append(group["lr"])
    return out


def onpolicy_graph_phase(torch) -> list[str]:
    """``OnPolicyTrainer``'s programs as CUDA graphs against the eager calls: PPO on
    ``NormObs(HalfCheetah())`` at ``OPG_E`` envs, with ``recompute_advantage``, the linear rate
    schedule, and a ``target_kl`` small enough that the guard trips after the first minibatch of a
    rollout. From one state and one generator state, each side (on deep copies) runs ``GRAPH_CALLS``
    rollouts of ``OPG_T`` steps, each followed by its update: the trainer's ``collect_chunk`` and
    ``update_rollout`` programs (eager warm-up, capture and replay, replay; the update is built again
    once, when the collect's capture replaces its eager output) against ``collector.rollout`` and
    ``algo.update_rollout``. The rollouts, the collect state (the normalization statistics included)
    and the minibatch permutations (logged on the device) must be bit-identical; weights, Adam's state,
    the rate, the return statistics and the stats within ``GRAPH_ATOL``; the guard must have tripped in
    every update, with the step counters equal to the untripped minibatches and the rate that of the
    last applied update."""
    import copy

    from tianshou_tpu_torch.algorithm.optim import linear_lr_schedule
    from tianshou_tpu_torch.ops.kernels import counters
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    sched = linear_lr_schedule(3e-4, OPG_TOTAL)
    algo, ts, coll = build_ppo(torch, "HalfCheetah", OPG_E, lr=sched, recompute_advantage=True,
                               target_kl=OPG_TARGET_KL, advantage_normalization=False, ppo_init=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    draw = algo.minibatch_indices
    n_mb = algo.minibatch_shape(OPG_T * OPG_E, OPG_BATCH)[0]
    sides = {}
    for side in ("graph", "eager"):
        s_ts, s_cs = copy.deepcopy((ts, cstate))
        s_gen = torch.Generator(device="cuda")
        s_gen.set_state(gen.get_state())
        sides[side] = dict(ts=s_ts, cstate=s_cs, gen=s_gen, outs=[], stats=[])
    del ts, cstate
    for side, sd in sides.items():
        algo.minibatch_indices, log = _logged(torch, draw, (GRAPH_CALLS, OPG_REPEAT, n_mb, OPG_T * OPG_E // n_mb))
        trainer = None
        if side == "graph":
            trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(
                batch_size=OPG_BATCH, collection_step_num_env_steps=OPG_T, update_step_num_repetitions=OPG_REPEAT,
                verbose=False))
        before = counters.snapshot()
        for _ in range(GRAPH_CALLS):
            if trainer is None:
                out = coll.rollout(sd["ts"], sd["cstate"], None, sd["gen"], OPG_T, keep_rollout=True)
                stats = algo.update_rollout(sd["ts"], out.rollout, sd["gen"], OPG_REPEAT, OPG_BATCH)[1]
            else:
                out = trainer.collect_chunk(sd["ts"], sd["cstate"], None, sd["gen"], OPG_T, keep_rollout=True)
                stats = trainer.update_rollout(sd["ts"], out.rollout, sd["gen"])
            sd["outs"].append(out.map(torch.clone))
            sd["stats"].append({k: v.clone() for k, v in stats.items()})
            sd.setdefault("steps", []).append(int(sd["ts"].step))
        torch.cuda.synchronize()
        after = counters.snapshot()
        sd["launches"] = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        sd["perm"] = log
        if trainer is not None:
            sd["graphs"] = {g.name.split()[0]: (g.replays, g.capture_s) for g in trainer.graph_pool.graphs}
            sd["pool_mib"] = trainer.graph_pool.memory_bytes() / 2**20
    algo.minibatch_indices = draw
    g, e = sides["graph"], sides["eager"]
    expect = {"collect_chunk": GRAPH_CALLS - 1, "update_rollout": GRAPH_CALLS - 2}
    if {n: r for n, (r, _) in g["graphs"].items()} != expect:
        raise AssertionError(f"on-policy graph phase: replays {g['graphs']}, expected {expect}")
    if int((e["perm"] < 0).sum()) or not torch.equal(g["perm"], e["perm"]):
        raise AssertionError("on-policy graph phase: the minibatch permutations differ from eager")
    if torch.equal(g["perm"][1], g["perm"][2]):
        raise AssertionError("on-policy graph phase: two replays drew the same permutations")
    worst = 0.0
    for call in range(GRAPH_CALLS):
        if not all(torch.equal(a, b) for a, b in zip(_leaves(g["outs"][call]), _leaves(e["outs"][call]))):
            raise AssertionError(f"on-policy graph phase: rollout {call} differs from eager")
        for k, v in e["stats"][call].items():
            worst = max(worst, float((g["stats"][call][k].double() - v.double()).abs().max()))
    if not all(torch.equal(a, b) for a, b in zip(_leaves(g["cstate"]), _leaves(e["cstate"]))):
        raise AssertionError("on-policy graph phase: the collect states (normalization statistics) differ")
    for a, b in zip(_onpolicy_tensors(torch, g["ts"], g["cstate"]), _onpolicy_tensors(torch, e["ts"], e["cstate"])):
        worst = max(worst, float((a.detach().double() - b.detach().double()).abs().max()))
    if worst > GRAPH_ATOL:
        raise AssertionError(f"on-policy graph phase: weights, Adam state or stats differ by {worst:.3e} > {GRAPH_ATOL}")
    if g["steps"] != e["steps"] or g["launches"] != e["launches"]:
        raise AssertionError(f"on-policy graph phase: steps {g['steps']} / {e['steps']}, launches {g['launches']} / "
                             f"{e['launches']}")
    per_update = OPG_REPEAT * n_mb
    kl_stop = [float(s["kl_stop"]) for s in g["stats"]]
    applied = [b - a for a, b in zip([0] + g["steps"][:-1], g["steps"])]
    # the last pass's stats: every one of its minibatches tripped once the guard tripped in an earlier pass
    if not all(0 < n < per_update for n in applied) or not all(k > 0 for k in kl_stop):
        raise AssertionError(f"on-policy graph phase: the guard did not trip mid-rollout: applied {applied} of "
                             f"{per_update}, kl_stop {kl_stop}")
    ts = g["ts"]
    count = _adam_count(ts)
    lr = ts.optim.param_groups[0]["lr"]
    want_lr = sched(count - 1)
    if int(count) != int(ts.step) or not torch.equal(lr, want_lr):
        raise AssertionError(f"on-policy graph phase: Adam count {int(count)}, step {int(ts.step)}, rate {float(lr)} "
                             f"against the schedule's {float(want_lr)}")
    return [f"on-policy graph phase, graphs against eager: PPO on NormObs(HalfCheetah) E={OPG_E}, {GRAPH_CALLS} "
            f"rollouts of T={OPG_T} each with its update ({OPG_REPEAT} passes x {n_mb} minibatches, recompute_advantage, "
            f"linear rate schedule, target_kl {OPG_TARGET_KL}); rollouts, normalization statistics and permutations "
            f"bit-identical; weights, Adam state, rate and stats max |diff| {worst:.3e} (tolerance {GRAPH_ATOL}); "
            f"updates applied per rollout {applied} of {per_update} (the rest tripped; step {int(ts.step)} = Adam count, "
            f"rate {float(lr):.6e} = the schedule's at count {int(count) - 1}); launches {g['launches']} as eager; "
            f"replays and capture s { {n: (r, round(c, 3)) for n, (r, c) in g['graphs'].items()} }; "
            f"pool {g['pool_mib']:.1f} MiB"]


def ppo_path(torch, task: str, steps: int, num_envs: int = PPO_E, batch: int = PPO_BATCH, iters: int = PPO_ITERS,
             name: str | None = None):
    """``bench.py:bench_mujoco_ppo`` in the port: PPO on ``NormObs(task)`` at E = ``num_envs``, one
    program of ``steps`` collect steps (``keep_rollout=True``) and then ``update_rollout`` (``PPO_REPEAT``
    passes, minibatches of ``batch``) as ONE CUDA graph, called for an eager warm-up, a capture, then
    ``iters`` timed replays. Then the collect and the update as ``OnPolicyTrainer``'s two programs, each
    replayed ``iters`` times between CUDA events, for their device times apart; the update must take the
    trainer's route of one graph (its gradient steps at most ``OnPolicyTrainer.STEP_GRAPHS_ABOVE``), which is
    the route of the megastep's graph too. Returns ({kernel: launches} over the megasteps, report lines, (the
    collector, its collect state) after the runs)."""
    import numpy as np

    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    name = name or f"ppo_{task.lower()}"
    algo, ts, coll = build_ppo(torch, task, num_envs)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    count0 = cstate.env_state.rms.count.clone()
    init = [p.detach().clone() for p in ts.model.parameters()]
    pool = GraphPool("cuda")
    n_mb = algo.minibatch_shape(steps * num_envs, batch)[0]
    n_grad = algo.rollout_grad_steps(steps * num_envs, PPO_REPEAT, batch)
    if n_grad > OnPolicyTrainer.STEP_GRAPHS_ABOVE:
        raise AssertionError(f"{name} path: {n_grad} gradient steps a rollout, above the one-graph route's "
                             f"{OnPolicyTrainer.STEP_GRAPHS_ABOVE}")

    def megastep():
        out = coll.rollout(ts, cstate, None, gen, steps, keep_rollout=True)
        return out, algo.update_rollout(ts, out.rollout, gen, PPO_REPEAT, batch)[1]

    program = Graphed(megastep, pool, (gen,), name="ppo_megastep")
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    walls, device_ms = [], []
    for call in range(2 + iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out, stats = program()
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        device_ms.append(a.elapsed_time(b))
    launches = _launches(gather, sumtree, physics_fused)
    calls = 2 + iters
    if launches != {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": calls * steps}:
        raise AssertionError(f"{name} path: kernel launches {launches} for {calls} megasteps of {steps} steps")
    if program.replays != calls - 1 or program.launches != {"physics_fused": steps}:
        raise AssertionError(f"{name} path: {program.replays} replays of {program.launches}")
    count = count0.cpu().numpy().astype(np.float32)
    for _ in range(calls * steps):  # the float32 running count, one observation per step
        count = count + np.float32(1.0)
    if not np.array_equal(cstate.env_state.rms.count.cpu().numpy(), count):
        raise AssertionError(f"{name} path: rms.count advanced to {cstate.env_state.rms.count[:4].tolist()}, expected "
                             f"{count[:4].tolist()}")
    tensors = _onpolicy_tensors(torch, ts, cstate) + list(stats.values())
    if not all(bool(torch.isfinite(t.double()).all()) for t in tensors if t.is_floating_point()):
        raise AssertionError(f"{name} path: a non-finite weight, statistic or loss")
    if all(torch.equal(a, b) for a, b in zip(init, ts.model.parameters())):
        raise AssertionError(f"{name} path: training left the weights unchanged")
    if int(ts.step) != calls * n_grad or out.rollout.obs.shape != (steps, num_envs, 17 if task == "HalfCheetah" else 27):
        raise AssertionError(f"{name} path: step {int(ts.step)}, rollout obs {tuple(out.rollout.obs.shape)}")

    # the collect and the update apart, as the trainer's two programs over the same states
    trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(
        batch_size=batch, collection_step_num_env_steps=steps, update_step_num_repetitions=PPO_REPEAT, verbose=False))
    held = coll.rollout(ts, cstate, None, gen, steps, keep_rollout=True)
    parts = {"collect": lambda: trainer.collect_chunk(ts, cstate, None, gen, steps, keep_rollout=True),
             "update": lambda: trainer.update_rollout(ts, held.rollout, gen)}
    apart = {}
    for part, fn in parts.items():
        fn(), fn()  # the eager warm-up, then the capture and a replay
        times = []
        for _ in range(iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        apart[part] = statistics.median(times)
    graphs = {g.name.split()[0]: g.replays for g in trainer.graph_pool.graphs}
    if trainer.step_graphs is not None or graphs != {"collect_chunk": iters + 1, "update_rollout": iters + 1}:
        raise AssertionError(f"{name} path: the trainer's programs {graphs}, step graphs {trainer.step_graphs}")
    wall = statistics.median(walls[2:])
    dev = statistics.median(device_ms[2:])
    lines = [
        f"{name} path: NormObs({task}) E={num_envs} T={steps} repeat={PPO_REPEAT} batch={batch} ({n_mb} minibatches "
        f"of {steps * num_envs // n_mb}); {calls} megasteps (eager warm-up, capture + replay, {iters} timed replays); "
        f"physics_fused launches {launches['physics_fused']} ({steps} per megastep), no other kernel; rms.count "
        f"{float(cstate.env_state.rms.count[0]):.4f} in every env (+{calls * steps}); update route: one graph, every "
        f"one of the {n_grad} minibatch steps inside the megastep's graph ({n_grad} <= OnPolicyTrainer."
        f"STEP_GRAPHS_ABOVE {OnPolicyTrainer.STEP_GRAPHS_ABOVE}; the trainer's update_rollout took the same route)",
        f"{name} path, graph replays: env_steps_per_s {steps * num_envs / wall:.1f} ms_per_megastep {wall * 1e3:.3f} "
        f"wall, {dev:.3f} device (eager warm-up {walls[0] * 1e3:.1f} ms, capture + replay {walls[1] * 1e3:.1f} ms); "
        f"apart: collect {apart['collect']:.3f} ms, update {apart['update']:.3f} ms of device time; "
        f"{_graph_report(pool, 1)}, the trainer's {trainer.graph_pool.memory_bytes() / 2**20:.1f} MiB; last stats "
        f"{ {k: round(float(v), 5) for k, v in stats.items()} }",
    ]
    return launches, lines, (coll, cstate)


def physics_at_scale(torch, coll, cstate, smi: str) -> tuple[dict, list[str]]:
    """``physics_fused`` at the width of the PPO path that ``coll`` steps (phase 58): on a near-home state of that
    many envs every env inside ``q`` ``Q_TOL`` / ``qd`` ``QD_TOL`` of the plain version (``dynamics.step``), and on
    the path's own state (its last collect state, random actions) at least ``MIN_SHARE_INSIDE`` of the envs, every
    output finite; then the kernel's device time per vector step on that state beside its first ``PHYS_E`` rows'
    in the same run, and the bound by the operations of its envs' active rows (``physics_flops``). Returns (the
    numbers, lines)."""
    from tianshou_tpu_torch.env.physics import dynamics
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    env = coll.venv.env.env  # NormObs(task) -> the MuJoCo env
    model, fs = env.model, env.frame_skip
    n_sub = fs * dynamics.resolve_substeps(model, env.substeps)
    E_, nu = coll.venv.num_envs, len(model.actuators)
    g = torch.Generator(device="cuda").manual_seed(3)
    home = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")
    near = (home + 0.03 * torch.randn(E_, model.nq, device="cuda", generator=g),
            0.05 * torch.randn(E_, model.nq, device="cuda", generator=g))
    own = (cstate.env_state.inner.q.contiguous(), cstate.env_state.inner.qd.contiguous())
    lines, shares = [], {}
    for what, (q, qd) in (("near home", near), ("the path's state", own)):
        ctrl = torch.rand(E_, nu, device="cuda", generator=g) * 2 - 1
        got = pf.fused_step(model, q, qd, ctrl, frame_skip=fs)
        want = pf.fused_step_reference(model, q, qd, ctrl, frame_skip=fs)
        if not all(bool(torch.isfinite(x).all()) for x in (*got, *want)):
            raise AssertionError(f"physics_fused E={E_} {what}: a non-finite output")
        ok = _inside(torch, got, want)
        shares[what] = float(ok.double().mean())
        if shares[what] < (1.0 if what == "near home" else MIN_SHARE_INSIDE):
            raise AssertionError(f"physics_fused E={E_} {what}: {int((~ok).sum())} envs outside q {Q_TOL} qd {QD_TOL}")
        lines.append(f"physics_fused {type(env).__name__} E={E_} {what}: {int((~ok).sum())} of {E_} envs outside q "
                     f"{Q_TOL} qd {QD_TOL} (share inside {shares[what]:.5f}), max |dq| "
                     f"{float((got[0] - want[0]).abs().max()):.3e} |dqd| {float((got[1] - want[1]).abs().max()):.3e}")
    q, qd = own
    ctrl = torch.rand(E_, nu, device="cuda", generator=g) * 2 - 1
    kern, kern_e = _time_ms(lambda: pf.fused_step(model, q, qd, ctrl, frame_skip=fs), warmup=2, runs=8, per_graph=3)
    sub = [t[:PHYS_E].contiguous() for t in (q, qd, ctrl)]
    kern_2k = _time_ms(lambda: pf.fused_step(model, *sub, frame_skip=fs), warmup=2, runs=8, per_graph=3)[0]
    contacts, limits = dynamics.active_rows(model, q)
    flops = physics_flops(model, contacts, limits, n_sub)
    by_ops = flops / H100_FP32_OPS_PER_S * 1e3
    by_bytes = E_ * (4 * model.nq + nu) * 4 / H100_HBM_BYTES_PER_S * 1e3
    bound = max(by_ops, by_bytes)
    # the launch: blocks of envs_per_block teams; resident blocks per SM at most what threads and shared memory allow
    info = pf.kernel_info(model)
    blocks, threads = -(-E_ // info["envs_per_block"]), info["envs_per_block"] * info["team"]
    resident = min(32, 2048 // threads, 232448 // (info["envs_per_block"] * info["shared_bytes_per_env"]))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rec = {"envs": E_, "ms": kern, "eager_ms": kern_e, "ms_first_2048": kern_2k, "bound_ms": bound,
           "bound_by": "operations" if by_ops >= by_bytes else "bytes", "gflop": flops / 1e9,
           "share_inside": shares, "blocks": blocks, "min_waves": blocks / (sms * resident)}
    lines.append(
        f"physics_fused {type(env).__name__} E={E_} x {n_sub} substeps on the path's state, us per vector step: kernel "
        f"{kern * 1e3:.2f} (CUDA graph) {kern_e * 1e3:.2f} (eager), its first {PHYS_E} rows {kern_2k * 1e3:.2f} in the "
        f"same run; {blocks} blocks of {threads} threads, at least {rec['min_waves']:.2f} waves on {sms} SMs (at most "
        f"{resident} resident blocks an SM by threads and shared memory); bound {bound * 1e3:.3f} us ({flops / 1e9:.3f} GFLOP over "
        f"{H100_FP32_OPS_PER_S / 1e12:.0f} TFLOP/s for active contacts per env {float(contacts.double().mean()):.2f}, "
        f"limits {float(limits.double().mean()):.2f}; by bytes {by_bytes * 1e3:.3f}), kernel at {bound / kern:.4f} of "
        f"the bound's rate [{smi}]")
    return rec, lines


def _rms_handoff_check(torch, trainer, name: str) -> list:
    """Wrap the test collector's ``collect_episodes`` so that each test phase checks that it got the
    train envs' pooled statistics of that moment and ran under them; returns the list it fills."""
    from tianshou_tpu_torch.env.wrappers import merge_rms

    handoffs = []
    collect_episodes = trainer.test_collector.collect_episodes

    def checked(*args, rms=None, **kw):
        want = merge_rms(trainer._cstate.env_state.rms)
        stats = collect_episodes(*args, rms=rms, **kw)
        slots = trainer.test_collector._episodes.cstate.env_state.rms
        if rms is None or not all(torch.equal(a, b) and torch.equal(s, b.expand_as(s))
                                  for a, b, s in zip(rms, want, slots)):
            raise AssertionError(f"{name}: a test phase did not run under the pooled train statistics")
        handoffs.append(float(want.count))
        return stats

    trainer.test_collector.collect_episodes = checked
    return handoffs


def ppo_cartpole_path(torch):
    """PPO on CartPole as ``tests/test_onpolicy.py:17-53`` trains it, through ``OnPolicyTrainer``
    with its collect, update and test graphs; it must reach ``CP_THRESHOLD``. Returns
    ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    torch.manual_seed(SEED)
    env = CartPole()
    algo = PPO(actor=DiscreteActor((64, 64), 2, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
               action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5), gamma=0.99,
               gae_lambda=0.95, eps_clip=0.2, ent_coef=0.01, deterministic_eval=True)
    tests = []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    params = OnPolicyTrainerParams(
        max_epochs=PCP_EPOCHS, epoch_num_steps=PCP_EPOCH_STEPS, test_step_num_episodes=10, batch_size=PCP_BATCH,
        collection_step_num_env_steps=PCP_T, update_step_num_repetitions=PCP_REPEAT,
        stop_fn=lambda r: r >= CP_THRESHOLD, compute_score_fn=score, verbose=False)
    trainer = OnPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, PCP_E, device="cuda"), algo, None),
                              DeviceCollector(VectorDeviceEnv(env, CP_E, device="cuda"), algo, None), params)
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res = trainer.run(algo.init("cuda"), torch.Generator(device="cuda").manual_seed(SEED))
    launches = _launches(gather, sumtree, physics_fused)
    if not res.best_reward >= CP_THRESHOLD:
        raise AssertionError(f"ppo_cartpole path: best test reward {res.best_reward} after {res.epochs} epochs, below "
                             f"the threshold {CP_THRESHOLD}")
    if any(launches.values()):
        raise AssertionError(f"ppo_cartpole path: kernel launches {launches}, expected none")
    graphs = {g.name.split()[0]: g for g in trainer.graph_pool.graphs}
    if sorted(graphs) != ["collect_chunk", "test_chunk", "update_rollout"]:
        raise AssertionError(f"ppo_cartpole path: programs {sorted(graphs)}")
    n_mb = algo.minibatch_shape(PCP_T * PCP_E, PCP_BATCH)[0]
    if res.gradient_step != res.env_step // (PCP_T * PCP_E) * PCP_REPEAT * n_mb or int(res.train_state.step) != res.gradient_step:
        raise AssertionError(f"ppo_cartpole path: gradient_step {res.gradient_step}, device step {int(res.train_state.step)}")
    t = res.timing
    train_s = t["collect"] + t["update"]
    captures = {n: round(g.capture_s, 3) for n, g in graphs.items() if g.capture_s is not None}
    # the two training graphs replayed alone, after the run: what a rollout costs once captured
    replay = {}
    for part in ("collect_chunk", "update_rollout"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PCP_REPLAYS):
            graphs[part]()
        torch.cuda.synchronize()
        replay[part] = (time.perf_counter() - t0) / PCP_REPLAYS
    return launches, [
        f"ppo_cartpole path: best test reward {res.best_reward:.1f} (threshold {CP_THRESHOLD}) after {res.epochs} epochs "
        f"(test reward by epoch {[round(float(s.returns.mean()), 1) for s in tests]}); env_steps {res.env_step} "
        f"gradient_steps {res.gradient_step}; wall {res.train_time:.2f} s (collect {t['collect']:.2f}, update "
        f"{t['update']:.2f}, test {t['test']:.2f}); train env_steps_per_s {res.env_step / train_s:.1f} (collect and update "
        f"time only; {res.env_step / (train_s - sum(v for k, v in captures.items() if k != 'test_chunk')):.1f} without the "
        f"captures, eager warm-ups included); test share {t['test'] / res.train_time:.3f}; capture s {captures}; "
        f"{_graph_report(trainer.graph_pool, 2)}",
        f"ppo_cartpole path, the training graphs replayed alone ({PCP_REPLAYS} times each after the run): collect "
        f"{replay['collect_chunk'] * 1e3:.3f} ms, update {replay['update_rollout'] * 1e3:.3f} ms per rollout of "
        f"{PCP_T * PCP_E} steps: env_steps_per_s {PCP_T * PCP_E / (replay['collect_chunk'] + replay['update_rollout']):.1f}",
    ]


def mujoco_example_path(torch, sde: bool = False):
    """``examples/mujoco/mujoco_ppo.py:27-80``'s defaults on HalfCheetah through ``OnPolicyTrainer``:
    16 envs of ``NormObs(HalfCheetah())``, rollouts of 128, 10 passes of batch 64 with
    ``recompute_advantage``, Adam 3e-4 with the linear decay over the run's updates, ``target_kl``
    0.015, the PPO init, 10 test episodes on 10 envs with frozen statistics; depth cut to
    ``MJ_EPOCHS`` epochs of ``MJ_EPOCH_STEPS`` steps. Checks: finite test returns, the pooled
    statistics at every handoff, the rate after the run against the schedule, ``kl_stop`` reported.
    With ``sde`` (``mujoco_ppo.py --sde``: gSDE, ``sigma_init`` ``SDE_SIGMA_INIT``) the depth is
    ``SDE_EPOCHS`` epochs and, after every collect chunk (a graph replay), each env's carried count
    must be the steps since the chunk's start or its last episode end in it (0 exactly where an
    episode ended at the chunk's last step); after the run, an eager loop of the train collector's
    steps must keep each env's noise bit-unchanged between resamples (``_sde_carry_check``).
    Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.algorithm.optim import linear_lr_schedule
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.wrappers import NormObs
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    name, epochs = ("ppo_sde_halfcheetah", SDE_EPOCHS) if sde else ("mujoco_example", MJ_EPOCHS)
    n_rollouts = max(1, epochs * MJ_EPOCH_STEPS // (MJ_E * MJ_T))
    n_mb = max(1, MJ_E * MJ_T // MJ_BATCH)
    sched = linear_lr_schedule(3e-4, n_rollouts * MJ_REPEAT * n_mb)
    algo, ts, train_c = build_ppo(torch, "HalfCheetah", MJ_E, lr=sched, ppo_init=True, advantage_normalization=False,
                                  recompute_advantage=True, vf_coef=0.25, ent_coef=0.0, deterministic_eval=True,
                                  target_kl=0.015, action_bound_method="clip",
                                  **(dict(sde=True, sigma_init=SDE_SIGMA_INIT) if sde else {}))
    test_c = DeviceCollector(VectorDeviceEnv(NormObs(train_c.venv.env.env, update_stats=False), 10, device="cuda"),
                             algo, None)
    tests = []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    trainer = OnPolicyTrainer(algo, train_c, test_c, OnPolicyTrainerParams(
        max_epochs=epochs, epoch_num_steps=MJ_EPOCH_STEPS, test_step_num_episodes=10, batch_size=MJ_BATCH,
        collection_step_num_env_steps=MJ_T, update_step_num_repetitions=MJ_REPEAT, compute_score_fn=score,
        verbose=False))
    handoffs = _rms_handoff_check(torch, trainer, f"{name} path")
    kl_stops = []
    log_update = trainer._log_update
    trainer._log_update = lambda stats: (kl_stops.append(float(stats.kl_stop)), log_update(stats))
    carried = _sde_count_check(torch, trainer) if sde else None
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res = trainer.run(ts, torch.Generator(device="cuda").manual_seed(SEED))
    launches = _launches(gather, sumtree, physics_fused)
    graphs = {g.name.split()[0]: g for g in trainer.graph_pool.graphs}
    test_steps = sum(s.n_collected_steps for s in tests) // 10
    if launches != {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0,
                    "physics_fused": res.env_step // MJ_E + test_steps}:
        raise AssertionError(f"{name} path: kernel launches {launches} for {res.env_step // MJ_E} train and "
                             f"{test_steps} test vector steps")
    import numpy as np

    if len(tests) != epochs or not all(s.n_collected_episodes == 10 and np.isfinite(s.returns).all() for s in tests):
        raise AssertionError(f"{name} path: test phases {[(s.n_collected_episodes, s.returns) for s in tests]}")
    if len(handoffs) != epochs:
        raise AssertionError(f"{name} path: {len(handoffs)} handoffs for {epochs} test phases")
    count = _adam_count(ts)
    lr, want_lr = ts.optim.param_groups[0]["lr"], sched(count - 1)
    if not torch.equal(lr, want_lr) or int(count) != int(ts.step):
        raise AssertionError(f"{name} path: rate {float(lr)} at Adam count {int(count)}, the schedule's "
                             f"{float(want_lr)}; step {int(ts.step)}")
    if len(kl_stops) != res.env_step // (MJ_E * MJ_T) or not all(np.isfinite(kl_stops)):
        raise AssertionError(f"{name} path: kl_stop {kl_stops}")
    t = res.timing
    tripped = sum(k > 0 for k in kl_stops)
    sde_lines = []
    if sde:
        if len(carried) != len(kl_stops) or not all(ok for ok, _ in carried) or not any(n for _, n in carried):
            raise AssertionError(f"{name} path: carried counts after each chunk {carried} (ok, envs whose episode ended)")
        sde_lines = [f"{name} path, gSDE carry: after each of {len(carried)} collect chunks (graph replays) every env's "
                     f"count equals the steps since the chunk's start or its last episode end (episodes ended in "
                     f"{sum(1 for _, n in carried if n)} chunks, {sum(n for _, n in carried)} env-episodes; count 0 "
                     f"exactly where one ended at the chunk's last step); {_sde_carry_check(torch, algo, ts, train_c)}"]
    return launches, sde_lines + [
        f"{name} path: NormObs(HalfCheetah) E={MJ_E} T={MJ_T} repeat={MJ_REPEAT} batch={MJ_BATCH} "
        f"recompute_advantage target_kl 0.015, linear rate decay over {sched.total_updates} updates (the example's "
        f"{n_rollouts} rollouts); {res.epochs} epochs of {MJ_EPOCH_STEPS} steps ({len(kl_stops)} rollouts): test reward "
        f"by epoch {[round(float(s.returns.mean()), 2) for s in tests]} (finite; no threshold at this depth); updates "
        f"applied {int(ts.step)} of {res.gradient_step} (gradient_step counts every minibatch); the guard tripped in "
        f"{tripped} of {len(kl_stops)} rollouts, kl_stop of the last passes mean {np.mean(kl_stops):.3f}; rate after the "
        f"run {float(lr):.6e} = the schedule's at count {int(count) - 1}; pooled statistics handed to the test envs at "
        f"{len(handoffs)} phases (counts {handoffs})",
        f"{name} path: wall {res.train_time:.2f} s (collect {t['collect']:.2f}, update {t['update']:.2f}, test "
        f"{t['test']:.2f}); train env_steps_per_s {res.env_step / (t['collect'] + t['update']):.1f} (collect and update "
        f"time only); capture s { {n: round(g.capture_s, 3) for n, g in graphs.items() if g.capture_s is not None} }; "
        f"{_graph_report(trainer.graph_pool, 2)}; launches {launches}",
    ]


# ---------------------------------------------------------------------------
# continuous off-policy: TD3, SAC and REDQ on the device physics; SAC, TD3 and DDPG on Pendulum
# ---------------------------------------------------------------------------
def make_offpolicy(torch, kind: str, env, hidden, lr: float, alpha=None):
    """``kind`` (ddpg, td3, sac or redq) as the examples build it (``examples/mujoco/mujoco_{ddpg,td3,sac,
    redq}.py``; ``tests/test_continuous.py`` for Pendulum): both optimizers Adam at ``lr``, gamma 0.99,
    tau 0.005; DDPG and TD3 with Gaussian exploration noise of sigma 0.1 (TD3: policy noise 0.2 clipped
    at 0.5, the actor every 2 steps); SAC's and REDQ's actor a conditioned-sigma tanh-Gaussian; REDQ
    over an ensemble of 10 critics, a subset of 2 and the actor every 20 steps."""
    from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
    from tianshou_tpu_torch.algorithm.modelfree.redq import REDQ
    from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
    from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.exploration.noise import GaussianNoise
    from tianshou_tpu_torch.models.continuous import (
        ContinuousActorDeterministic,
        ContinuousActorProbabilistic,
        ContinuousCritic,
        EnsembleCritic,
    )

    obs_dim, nu = env.observation_space.shape[0], env.action_space.shape[0]
    common = dict(action_space=env.action_space, policy_optim=AdamOptimizerFactory(lr=lr),
                  critic_optim=AdamOptimizerFactory(lr=lr), gamma=0.99, tau=0.005)
    critic = ContinuousCritic(hidden, input_dim=obs_dim, action_dim=nu)
    if kind in ("ddpg", "td3"):
        actor = ContinuousActorDeterministic(hidden, nu, input_dim=obs_dim)
        noise = GaussianNoise(sigma=0.1)
        if kind == "ddpg":
            return DDPG(actor=actor, critic=critic, exploration_noise=noise, **common)
        return TD3(actor=actor, critic=critic, exploration_noise=noise, policy_noise=0.2, noise_clip=0.5,
                   update_actor_freq=2, **common)
    actor = ContinuousActorProbabilistic(hidden, nu, conditioned_sigma=True, input_dim=obs_dim)
    if kind == "sac":
        return SAC(actor=actor, critic=critic, alpha=alpha, **common)
    return REDQ(actor=actor, critic=EnsembleCritic(10, hidden, input_dim=obs_dim, action_dim=nu), ensemble_size=10,
                subset_size=2, alpha=alpha, actor_delay=20, **common)


def offpolicy_buffer(torch, env, size: int, num_envs: int, prio: bool = False):
    """A float replay of ``size`` rows over ``num_envs`` rings on the card (PER: alpha 0.6, beta 0.4):
    (buffer, state)."""
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer

    buffer = (PrioritizedVectorReplayBuffer(size, num_envs, alpha=0.6, beta=0.4) if prio
              else VectorReplayBuffer(size, num_envs))
    obs_dim, nu = env.observation_space.shape[0], env.action_space.shape[0]
    state = buffer.init(Batch(obs=torch.zeros(obs_dim), act=torch.zeros(nu), rew=torch.tensor(0.0),
                              terminated=torch.tensor(False), truncated=torch.tensor(False),
                              obs_next=torch.zeros(obs_dim)), device="cuda")
    return buffer, state


def _offpolicy_state_tensors(ts, bs, cstate) -> list:
    """Every tensor a continuous off-policy chunk writes: weights, targets, ``log_alpha``, every
    optimizer's state, the step, the rings (and the sum tree) and the collect state."""
    from tianshou_tpu_torch.algorithm.base import optimizer_tensors
    from tianshou_tpu_torch.data.buffer.prio import PrioState

    out = [*ts.model.state_dict().values(), *ts.target.state_dict().values(), ts.step]
    for opt in ts.optim.values():
        out += optimizer_tensors(opt)
    base = bs.base if isinstance(bs, PrioState) else bs
    out += [base.cursor, base.size, base.last_idx, *base.data.values(), *_leaves(cstate)]
    if isinstance(bs, PrioState):
        out += [bs.tree, bs.max_prio, bs.min_prio]
    return out


def offpolicy_graph_phase(torch, kind: str) -> list[str]:
    """``OffPolicyTrainer``'s programs as CUDA graphs against the eager loop for TD3, SAC
    (``alpha="auto"``) and REDQ on HalfCheetah at the examples' widths (32 envs, 256x256 nets, batch
    256; REDQ's 10 critics): from one prefilled state and one generator state, on deep copies,
    ``GRAPH_CALLS`` collect chunks of ``OFF_T`` steps and ``GRAPH_CALLS`` bursts of ``GRAPH_K`` updates
    (steps 0-23: TD3 on both sides of its delay of 2, REDQ across its step 20) through the trainer's
    programs against ``collector.collect`` and ``algo.update``. Every weight, target, ``log_alpha``,
    Adam state, the rings, the collect state, the collect output and the stats bit-identical; the actor's
    Adam count the number of applied actor steps (TD3 12, REDQ 2, SAC 24). Then, for SAC, the alpha and
    actor optimizers on the card against the CPU (``adam_check``)."""
    import copy

    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import counters
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    torch.manual_seed(SEED)
    env = make("HalfCheetah")
    algo = make_offpolicy(torch, kind, env, OFF_HID, lr=1e-3 if kind != "td3" else 3e-4, alpha="auto")
    ts = algo.init("cuda")
    buffer, bs = offpolicy_buffer(torch, env, OFF_E * 256, OFF_E)
    coll = DeviceCollector(VectorDeviceEnv(env, OFF_E, device="cuda"), algo, buffer)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    coll.collect(ts, cstate, bs, gen, 16, random=True)  # 512 rows to sample from
    sides = {}
    for side in ("graph", "eager"):
        s_ts, s_bs, s_cs = copy.deepcopy((ts, bs, cstate))
        s_gen = torch.Generator(device="cuda")
        s_gen.set_state(gen.get_state())
        sides[side] = dict(ts=s_ts, bs=s_bs, cstate=s_cs, gen=s_gen, outs=[], stats=[])
    del ts, bs, cstate
    for side, sd in sides.items():
        trainer = None
        if side == "graph":
            trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(
                batch_size=OFF_BATCH, collection_step_num_env_steps=OFF_T, verbose=False))
        before = counters.snapshot()
        for _ in range(GRAPH_CALLS):
            if trainer is None:
                out = coll.collect(sd["ts"], sd["cstate"], sd["bs"], sd["gen"], OFF_T)[2]
            else:
                out = trainer.collect_chunk(sd["ts"], sd["cstate"], sd["bs"], sd["gen"], OFF_T)
            sd["outs"].append(out.map(torch.clone))
        for _ in range(GRAPH_CALLS):
            if trainer is None:
                stats = [algo.update(sd["ts"], buffer, sd["bs"], sd["gen"], OFF_BATCH)[2] for _ in range(GRAPH_K)]
                stats = {k: torch.stack([s[k] for s in stats]) for k in stats[0].keys()}
            else:
                stats = trainer.update_burst(sd["ts"], sd["bs"], sd["gen"], GRAPH_K)
            sd["stats"].append({k: v.clone() for k, v in stats.items()})
        torch.cuda.synchronize()
        after = counters.snapshot()
        sd["launches"] = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        if trainer is not None:
            sd["graphs"] = {g.name.split()[0]: (g.replays, g.capture_s) for g in trainer.graph_pool.graphs}
            sd["pool_mib"] = trainer.graph_pool.memory_bytes() / 2**20
    g, e = sides["graph"], sides["eager"]
    name = f"continuous graph phase {kind}"
    if {n: r for n, (r, _) in g["graphs"].items()} != {"collect_chunk": GRAPH_CALLS - 1, "update_burst": GRAPH_CALLS - 1}:
        raise AssertionError(f"{name}: replays {g['graphs']}")
    worst = 0.0
    for call in range(GRAPH_CALLS):
        if not all(torch.equal(a, b) for a, b in zip(_leaves(g["outs"][call]), _leaves(e["outs"][call]))):
            raise AssertionError(f"{name}: collect output {call} differs from eager")
        for k, v in e["stats"][call].items():
            worst = max(worst, float((g["stats"][call][k].double() - v.double()).abs().max()))
    pairs = list(zip(_offpolicy_state_tensors(g["ts"], g["bs"], g["cstate"]),
                     _offpolicy_state_tensors(e["ts"], e["bs"], e["cstate"])))
    for a, b in pairs:
        worst = max(worst, float((a.detach().double() - b.detach().double()).abs().max()))
    if worst != 0.0 or not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{name}: the graphs differ from eager by {worst:.3e}")
    n_updates = GRAPH_CALLS * GRAPH_K
    applied = {"td3": n_updates // 2, "redq": sum(s % 20 == 0 for s in range(n_updates)), "sac": n_updates}[kind]
    ts = g["ts"]
    actor_count = int(ts.optim["actor"].state[next(iter(ts.model["actor"].parameters()))]["step"])
    if int(ts.step) != n_updates or actor_count != applied or g["launches"] != e["launches"]:
        raise AssertionError(f"{name}: step {int(ts.step)}, actor steps applied {actor_count} (expected {applied}), "
                             f"launches {g['launches']} / {e['launches']}")
    lines = []
    if kind == "sac":
        lines.append(f"{name}: alpha " + adam_check(torch, algo.alpha_optim, [ts.model.log_alpha]))
        lines.append(f"{name}: actor " + adam_check(torch, algo.policy_optim, list(ts.model["actor"].parameters())))
    log_alpha = f", log_alpha {float(ts.model.log_alpha.detach()):.6f}" if hasattr(ts.model, "log_alpha") else ""
    return lines + [
        f"{name}, graphs against eager: HalfCheetah E={OFF_E}, nets {OFF_HID}, batch {OFF_BATCH}; {GRAPH_CALLS} collect "
        f"chunks of T={OFF_T} and {GRAPH_CALLS} x {GRAPH_K} updates; weights, targets, Adam state, rings, collect state "
        f"and output and stats bit-identical, max |diff| {worst:.3e}; actor steps applied {actor_count} of {n_updates}"
        f"{log_alpha}; launches {g['launches']} as eager; replays and capture s "
        f"{ {n: (r, round(c, 3)) for n, (r, c) in g['graphs'].items()} }; pool {g['pool_mib']:.1f} MiB"]


def offpolicy_path(torch, name: str):
    """The path ``name`` of ``OFF_PATHS`` through ``OffPolicyTrainer`` with ``fused_megastep``: the
    example's defaults (32 envs, T 4, one update per env step: 128 per megastep, batch 256, a 1 M-row
    replay, 256x256 nets, a random prefill, 10 test episodes on 10 envs), the depth cut to one epoch.
    Checks: exactly one ``physics_fused`` launch per vector step (prefill, training and test); over PER
    one descent per update and one tree update per update and per collect step, prefill included, and an
    exactly consistent tree; the update count; finite weights and test returns. Then the megastep graph
    replayed ``OFF_REPLAYS`` times for its wall and device time. Returns ({kernel: launches}, lines)."""
    import numpy as np

    from tianshou_tpu_torch.data.buffer.prio import PrioState
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    task, kind, prefill, epoch_steps, prio = OFF_PATHS[name]
    torch.manual_seed(SEED)
    env = make(task)
    # on the plain route (Humanoid) the test phase runs after training, eagerly, in chunks of HUM_TEST_CHUNK steps
    plain = env.physics_route == "plain"
    algo = make_offpolicy(torch, kind, env, OFF_HID, **OFF_ALGOS[kind])
    ts = algo.init("cuda")
    init = [p.detach().clone() for p in ts.model.parameters()]
    buffer, bs = offpolicy_buffer(torch, env, OFF_BUFFER, OFF_E, prio)
    tests = []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    test_coll = DeviceCollector(VectorDeviceEnv(env, OFF_TEST_E, device="cuda"), algo, None)
    trainer = OffPolicyTrainer(
        algo, DeviceCollector(VectorDeviceEnv(env, OFF_E, device="cuda"), algo, buffer),
        None if plain else test_coll, buffer,
        OffPolicyTrainerParams(max_epochs=1, epoch_num_steps=epoch_steps, test_step_num_episodes=OFF_TEST_E,
                               batch_size=OFF_BATCH, collection_step_num_env_steps=OFF_T, update_per_step=1.0,
                               start_steps=prefill, start_random=True, fused_megastep=True, compute_score_fn=score,
                               verbose=False))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res = trainer.run(ts, bs, gen)
    if plain:
        t0 = time.perf_counter()
        score(test_coll.collect_episodes(ts, gen, OFF_TEST_E, chunk_steps=HUM_TEST_CHUNK, training=False))
        res.timing["test"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = _launches(gather, sumtree, physics_fused)

    chunk = OFF_T * OFF_E
    n_updates = round(1.0 * chunk)
    prefill_chunks, chunks = -(-prefill // chunk), -(-epoch_steps // chunk)
    train_steps = (prefill_chunks + chunks) * OFF_T  # vector steps, one buffer add each
    test_steps = sum(s.n_collected_steps for s in tests) // OFF_TEST_E
    graphs = {gr.name.split()[0]: gr for gr in trainer.graph_pool.graphs}
    programs = ["megastep"] if plain else ["megastep", "test_chunk"]
    if sorted(graphs) != programs or graphs["megastep"].replays != chunks - 1:
        raise AssertionError(f"{name} path: programs { {n: gr.replays for n, gr in graphs.items()} }")
    if res.env_step != train_steps * OFF_E or res.gradient_step != chunks * n_updates or int(ts.step) != res.gradient_step:
        raise AssertionError(f"{name} path: env_step {res.env_step}, gradient_step {res.gradient_step}, step {int(ts.step)}")
    expect = {"gather_rows": 0, "prefix_sum_idx": res.gradient_step if prio else 0,
              "tree_update": res.gradient_step + train_steps if prio else 0,
              "physics_fused": 0 if plain else train_steps + test_steps}
    if launches != expect:
        raise AssertionError(f"{name} path: kernel launches {launches}, expected {expect} ({train_steps} train and "
                             f"{test_steps} test vector steps, {res.gradient_step} updates)")
    if len(tests) != 1 or tests[0].n_collected_episodes != OFF_TEST_E or not np.isfinite(tests[0].returns).all():
        raise AssertionError(f"{name} path: test phases {[(s.n_collected_episodes, s.returns) for s in tests]}")
    if not all(bool(torch.isfinite(p).all()) for p in ts.model.parameters()) or \
            all(torch.equal(a, b) for a, b in zip(init, ts.model.parameters())):
        raise AssertionError(f"{name} path: non-finite or unchanged weights after training")
    loss = res.last_chunk_stats.loss
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"{name} path: non-finite loss in the last megastep")
    tree_line = [f"{name} path: " + _check_tree(torch, buffer, bs, gen, OFF_BATCH)] if prio else []
    # the megastep graph replayed alone, after the checks: its wall and device time
    walls, device = [], []
    for _ in range(OFF_REPLAYS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        graphs["megastep"]()
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        device.append(a.elapsed_time(b))
    wall, dev = statistics.median(walls), statistics.median(device)
    t = res.timing
    captures = {n: round(gr.capture_s, 3) for n, gr in graphs.items()}
    route = (f"; the plain route (dynamics.step with pair rows, no kernel); test phase eager, chunks of {HUM_TEST_CHUNK} "
             f"steps, after the epoch" if plain else "")
    return launches, tree_line + [
        f"{name} path{route}: {kind} on {task}, E={OFF_E} T={OFF_T} batch={OFF_BATCH} nets {OFF_HID}, {n_updates} updates per "
        f"megastep, {'PER alpha 0.6 beta 0.4 ' if prio else ''}replay of {OFF_BUFFER} rows; prefill {prefill_chunks * chunk} "
        f"random steps, 1 epoch of {chunks * chunk} steps (depth cut); test reward {float(tests[0].returns.mean()):.3f} "
        f"(10 episodes, lengths mean {tests[0].lens.mean():.1f}); launches {launches} = {train_steps} train + "
        f"{test_steps} test vector steps{f', {res.gradient_step} updates' if prio else ''}",
        f"{name} path: wall {res.train_time:.2f} s (prefill {t['prefill']:.2f}, megasteps {t['collect']:.2f}, test "
        f"{t['test']:.2f}); train env_steps_per_s {chunks * chunk / t['collect']:.1f} over the run (eager warm-up and "
        f"capture included); replayed megastep {wall * 1e3:.3f} ms wall, {dev:.3f} ms device = "
        f"{chunk / wall:.1f} env_steps_per_s, {wall / n_updates * 1e3:.4f} ms per update (collect included); capture s "
        f"{captures}; graph pool {trainer.graph_pool.memory_bytes() / 2**20:.1f} MiB; last losses "
        f"{ {k: round(float(v.mean()), 4) for k, v in res.last_chunk_stats.items() if k != 'td_error'} }",
    ]


def pendulum_path(torch, kind: str, task: str = "Pendulum"):
    """``kind`` (sac, td3 or ddpg) on ``Pendulum`` as ``tests/test_continuous.py:22-86`` trains it, or SAC on
    ``InvertedPendulum`` as ``tests/test_mujoco_table.py:41-53`` does (the ``IP_*`` settings), through
    ``OffPolicyTrainer`` and its collect, update and test graphs: Pendulum with 8 train and 10 test envs,
    128x128 nets, a 50,000-row replay, batch 128, T 8, 0.5 updates per env step, a prefill of 2,000
    steps with the policy's own actions, at most 12 epochs of 4,000 steps; it must reach -250.
    InvertedPendulum must reach 1,000. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.inverted_pendulum import InvertedPendulum
    from tianshou_tpu_torch.env.classic.pendulum import Pendulum
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    if task == "Pendulum":
        name, env, algo_kw = f"pendulum_{kind}", Pendulum(), PEND_ALGOS[kind]
        n_env, hid, size, batch, T, utd = PEND_E, PEND_HID, PEND_BUFFER, PEND_BATCH, PEND_T, PEND_UTD
        prefill, epochs, epoch_steps, threshold = PEND_PREFILL, PEND_EPOCHS, PEND_EPOCH_STEPS, PEND_THRESHOLD
    else:
        name, env, algo_kw = f"inverted_pendulum_{kind}", InvertedPendulum(), dict(lr=3e-4, alpha="auto")
        n_env, hid, size, batch, T, utd = IP_E, IP_HID, IP_BUFFER, IP_BATCH, IP_T, IP_UTD
        prefill, epochs, epoch_steps, threshold = IP_PREFILL, IP_EPOCHS, IP_EPOCH_STEPS, IP_THRESHOLD
    torch.manual_seed(SEED)
    algo = make_offpolicy(torch, kind, env, hid, **algo_kw)
    buffer, bs = offpolicy_buffer(torch, env, size, n_env)
    tests = []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    trainer = OffPolicyTrainer(
        algo, DeviceCollector(VectorDeviceEnv(env, n_env, device="cuda"), algo, buffer),
        DeviceCollector(VectorDeviceEnv(env, PEND_TEST_E, device="cuda"), algo, None), buffer,
        OffPolicyTrainerParams(max_epochs=epochs, epoch_num_steps=epoch_steps, test_step_num_episodes=10,
                               batch_size=batch, collection_step_num_env_steps=T, update_per_step=utd,
                               start_steps=prefill, start_random=False, stop_fn=lambda r: r >= threshold,
                               compute_score_fn=score, verbose=False))
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res = trainer.run(algo.init("cuda"), bs, torch.Generator(device="cuda").manual_seed(SEED))
    launches = _launches(gather, sumtree, physics_fused)
    if not res.best_reward >= threshold:
        raise AssertionError(f"{name} path: best test reward {res.best_reward} after {res.epochs} epochs, below the "
                             f"threshold {threshold}")
    graphs = {g.name.split()[0]: g for g in trainer.graph_pool.graphs}
    if any(launches.values()) or sorted(graphs) != ["collect_chunk", "test_chunk", "update_burst"]:
        raise AssertionError(f"{name} path: launches {launches}, programs {sorted(graphs)}")
    if res.gradient_step != int(res.train_state.step):
        raise AssertionError(f"{name} path: gradient_step {res.gradient_step}, step {int(res.train_state.step)}")
    t = res.timing
    train_steps = res.env_step - prefill
    alpha = (f"; alpha {float(res.train_state.model.log_alpha.detach().exp()):.4f}"
             if hasattr(res.train_state.model, "log_alpha") else "")
    return launches, [
        f"{name} path: best test reward {res.best_reward:.1f} (threshold {threshold}) after {res.epochs} epochs "
        f"(test reward by epoch {[round(float(s.returns.mean()), 1) for s in tests]}){alpha}; env_steps {res.env_step} "
        f"gradient_steps {res.gradient_step}; wall {res.train_time:.2f} s (prefill {t['prefill']:.2f}, collect "
        f"{t['collect']:.2f}, update {t['update']:.2f}, test {t['test']:.2f}); train env_steps_per_s "
        f"{train_steps / (t['collect'] + t['update']):.1f} (collect and update time, captures included); capture s "
        f"{ {n: round(g.capture_s, 3) for n, g in graphs.items()} }; {_graph_report(trainer.graph_pool, 2)}",
    ]


def dist_score_path(torch, name: str):
    """``fqf_cartpole`` or ``bdqn_pendulum`` as ``tests/test_distributional.py:89-107`` trains them (its ``run``:
    the ``DS_*`` settings, ``COMMON`` for FQF, eps 0.3 annealed to 0.1 over 30,000 steps), on the card through
    ``OffPolicyTrainer`` and its collect, update and test graphs; stops at the threshold of ``DIST_SCORE``
    and raises below it. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.algorithm.modelfree.bdqn import BDQN
    from tianshou_tpu_torch.algorithm.modelfree.fqf import FQF
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.classic.pendulum import Pendulum
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.wrappers import ContinuousToDiscrete
    from tianshou_tpu_torch.models.discrete import ImplicitQuantileNetwork
    from tianshou_tpu_torch.models.mlp import BranchingNet
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    threshold = DIST_SCORE[name]
    torch.manual_seed(SEED)
    if name == "fqf_cartpole":
        env = CartPole()
        algo = FQF(model=ImplicitQuantileNetwork((64, 64), 2, input_dim=4), action_space=env.action_space,
                   num_fractions=32, ent_coef=10.0, optim=AdamOptimizerFactory(lr=1e-3), gamma=0.95,
                   n_step_return_horizon=3, target_update_freq=320, eps_training=0.3)
        act = torch.tensor(0)
    else:
        env = ContinuousToDiscrete(Pendulum(), 25)
        algo = BDQN(model=BranchingNet((128, 128), 1, 25, input_dim=3), action_space=env.action_space, gamma=0.99,
                    target_update_freq=320, eps_training=0.3, optim=AdamOptimizerFactory(lr=1e-3))
        act = torch.zeros(1, dtype=torch.int64)
    obs_shape = env.observation_space.shape
    buffer = VectorReplayBuffer(DS_BUFFER, DS_E)
    bs = buffer.init(Batch(obs=torch.zeros(obs_shape), act=act, rew=torch.tensor(0.0), terminated=torch.tensor(False),
                           truncated=torch.tensor(False), obs_next=torch.zeros(obs_shape)), device="cuda")
    tests = []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    trainer = OffPolicyTrainer(
        algo, DeviceCollector(VectorDeviceEnv(env, DS_E, device="cuda"), algo, buffer),
        DeviceCollector(VectorDeviceEnv(env, DS_E, device="cuda"), algo, None), buffer,
        OffPolicyTrainerParams(max_epochs=DS_EPOCHS, epoch_num_steps=DS_EPOCH_STEPS, test_step_num_episodes=10,
                               batch_size=DS_BATCH, collection_step_num_env_steps=DS_T, update_per_step=0.1,
                               start_steps=DS_PREFILL, stop_fn=lambda r: r >= threshold, compute_score_fn=score,
                               train_fn=lambda epoch, step: {"eps_training": max(0.1, 0.3 * (1 - step / 30000))},
                               verbose=False))
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res = trainer.run(algo.init("cuda"), bs, torch.Generator(device="cuda").manual_seed(SEED))
    launches = _launches(gather, sumtree, physics_fused)
    if not res.best_reward >= threshold:
        raise AssertionError(f"{name} path: best test reward {res.best_reward} after {res.epochs} epochs, below the "
                             f"threshold {threshold}")
    graphs = {g.name.split()[0]: g for g in trainer.graph_pool.graphs}
    if any(launches.values()) or sorted(graphs) != ["collect_chunk", "test_chunk", "update_burst"]:
        raise AssertionError(f"{name} path: launches {launches}, programs {sorted(graphs)}")
    t = res.timing
    train_steps = res.env_step - DS_PREFILL
    return launches, [
        f"{name} path: best test reward {res.best_reward:.1f} (threshold {threshold}) after {res.epochs} epochs "
        f"(test reward by epoch {[round(float(s.returns.mean()), 1) for s in tests]}); env_steps {res.env_step} "
        f"gradient_steps {res.gradient_step}; wall {res.train_time:.2f} s (prefill {t['prefill']:.2f}, collect "
        f"{t['collect']:.2f}, update {t['update']:.2f}, test {t['test']:.2f}); train env_steps_per_s "
        f"{train_steps / (t['collect'] + t['update']):.1f} (collect and update time, captures included); capture s "
        f"{ {n: round(g.capture_s, 3) for n, g in graphs.items()} }",
    ]


# ---------------------------------------------------------------------------
# the rest of the on-policy family: NPG and TRPO on the device physics and on CartPole, gSDE, the MLP PPO bench
# ---------------------------------------------------------------------------
def _sde_count_check(torch, trainer) -> list:
    """Wrap ``trainer.collect_chunk`` so that after every chunk (a graph replay) it checks each env's
    carried gSDE count: the per-chunk refresh sets it to 0, each step adds 1 and an episode's end sets
    it to 0, so after ``T`` steps it is ``T - 1 - t`` for an env whose last episode end in the chunk
    was at step ``t``, and ``T`` for an env with none. Returns the list it fills with (ok, envs whose
    episode ended in the chunk)."""
    checks = []
    collect_chunk = trainer.collect_chunk

    def checked(ts, cstate, buf_state, generator, n_steps, keep_rollout=None):
        out = collect_chunk(ts, cstate, buf_state, generator, n_steps, keep_rollout)
        step = torch.arange(n_steps, device=out.done.device)[:, None]
        last = torch.where(out.done, step, -1).max(0).values
        want = torch.where(last >= 0, n_steps - 1 - last, n_steps).to(torch.int32)
        checks.append((torch.equal(cstate.policy_state.count, want), int((last >= 0).sum())))
        return out

    trainer.collect_chunk = checked
    return checks


def _sde_carry_check(torch, algo, ts, coll, steps: int = 13) -> str:
    """``steps`` eager steps of ``coll`` from a fresh state: where an env's count before a step is not a
    multiple of ``sde_sample_freq`` (and its episode goes on) its noise must come out bit-unchanged, and
    where it is, fresh; returns the report."""
    from tianshou_tpu_torch.utils.tree import tree_map

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cstate = coll.reset(gen)
    kept = fresh = 0
    for _ in range(steps):
        before = cstate.policy_state.eps.clone(), cstate.policy_state.count.clone()
        new, _, per = coll._step_fn(ts, cstate, None, gen, True, False, False)
        hold = (before[1] % algo.sde_sample_freq != 0) & ~per.done
        same = (new.policy_state.eps == before[0]).flatten(1).all(1)
        if not torch.equal(same[hold], torch.ones_like(same[hold])) or bool(same[~hold & ~per.done].any()):
            raise AssertionError(f"gSDE carry: noise changed between resamples or stayed at a resample "
                                 f"(count {before[1].tolist()})")
        kept, fresh = kept + int(hold.sum()), fresh + int((~hold & ~per.done).sum())
        tree_map(torch.Tensor.copy_, cstate, new)
    return (f"eager check of {steps} steps: the noise bit-unchanged in {kept} env-steps between resamples and drawn "
            f"anew in {fresh} (sde_sample_freq {algo.sde_sample_freq})")


def build_trust_region(torch, kind: str, num_envs: int):
    """``examples/mujoco/mujoco_{npg,trpo}.py``'s algorithm on ``NormObs(HalfCheetah())`` in the port: the
    PPO-init 64x64 actor and critic, Adam 1e-3, gamma 0.99, lambda 0.95, ``TR_CRITIC_ITERS`` critic
    steps, the clip bound, a deterministic test; NPG's step 0.5, TRPO's ``max_kl`` 0.01, backtracking by
    0.8 up to 10 times. Returns (algo, train state, collector)."""
    from tianshou_tpu_torch.algorithm.modelfree.npg import NPG
    from tianshou_tpu_torch.algorithm.modelfree.trpo import TRPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.env.wrappers import NormObs
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    torch.manual_seed(SEED)
    env = NormObs(make("HalfCheetah"))
    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    cls, opts = {"npg": (NPG, dict(trust_region_size=0.5)),
                 "trpo": (TRPO, dict(max_kl=0.01, backtrack_coeff=0.8, max_backtracks=10))}[kind]
    algo = cls(actor=ContinuousActorProbabilistic((64, 64), nu, ppo_init=True, input_dim=obs_dim),
               critic=ContinuousCritic((64, 64), use_action=False, ppo_init=True, input_dim=obs_dim),
               action_space=env.action_space, optim=AdamOptimizerFactory(lr=1e-3), gamma=0.99, gae_lambda=0.95,
               optim_critic_iters=TR_CRITIC_ITERS, action_bound_method="clip", deterministic_eval=True, **opts)
    return algo, algo.init("cuda"), DeviceCollector(VectorDeviceEnv(env, num_envs, device="cuda"), algo, None)


def trust_region_graph_phase(torch) -> list[str]:
    """NPG's and TRPO's ``update_rollout`` (the conjugate gradient by double backward, TRPO's line
    search by select) as the trainer's CUDA graph against the eager call, at ``mujoco_{npg,trpo}.py``'s
    widths (16 envs of ``NormObs(HalfCheetah())``, T 64, one minibatch of 1,024 rows, 20 critic steps):
    from one state, on deep copies, ``GRAPH_CALLS`` collected rollouts each updated by both (the program:
    eager warm-up, capture and replay, replay). Weights, every optimizer tensor (the critic's Adam
    moments and the shared count) and every stat (``step_frac`` and ``accepted`` too) bit-identical.
    Then a PPO+gSDE collect chunk (``mujoco_ppo.py --sde``'s actor, 16 envs, ``SDE_GRAPH_T`` steps, so
    that the third chunk crosses HalfCheetah's episode end at step 1,000) as the trainer's graph
    against the eager chunk: rollouts, the collect state with its carried noise and counts, and
    ``physics_fused``'s launches bit-identical. cuDNN is held to deterministic algorithms for the phase."""
    import copy

    from tianshou_tpu_torch.algorithm.base import optimizer_tensors
    from tianshou_tpu_torch.ops.kernels import counters
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    lines = []
    for kind in ("npg", "trpo"):
        algo, ts, coll = build_trust_region(torch, kind, TR_E)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        cstate = coll.reset(gen)
        rollouts = [coll.rollout(ts, cstate, None, gen, TR_T, keep_rollout=True).rollout.map(torch.clone)
                    for _ in range(GRAPH_CALLS)]
        ets = copy.deepcopy(ts)
        held = rollouts[0].map(torch.clone)
        trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(
            batch_size=TR_BATCH, collection_step_num_env_steps=TR_T, update_step_num_repetitions=1, verbose=False))
        ugen, egen = (torch.Generator(device="cuda").manual_seed(SEED + 1) for _ in range(2))
        worst, stats_seen = 0.0, []
        for roll in rollouts:
            for k in roll.keys():
                held[k].copy_(roll[k])
            stats = {k: v.clone() for k, v in trainer.update_rollout(ts, held, ugen).items()}
            estats = algo.update_rollout(ets, roll, egen, 1, TR_BATCH)[1]
            for k, v in estats.items():
                worst = max(worst, float((stats[k].double() - v.double()).abs().max()))
            stats_seen.append(stats)
        torch.cuda.synchronize()
        for a, b in zip([*ts.model.parameters(), *optimizer_tensors(ts.optim), ts.step],
                        [*ets.model.parameters(), *optimizer_tensors(ets.optim), ets.step]):
            worst = max(worst, float((a.detach().double() - b.detach().double()).abs().max()))
        graphs = {g.name.split()[0]: (g.replays, g.capture_s) for g in trainer.graph_pool.graphs}
        if worst != 0.0 or graphs["update_rollout"][0] != GRAPH_CALLS - 1:
            raise AssertionError(f"trust-region graph phase {kind}: max |diff| {worst:.3e} against eager, replays {graphs}")
        count = _adam_count(ts)
        if int(count) != GRAPH_CALLS * TR_CRITIC_ITERS or int(ts.step) != GRAPH_CALLS:
            raise AssertionError(f"trust-region graph phase {kind}: Adam count {int(count)}, step {int(ts.step)}")
        extra = ""
        if kind == "trpo":
            extra = (f"; step_frac by rollout {[float(s['step_frac']) for s in stats_seen]}, accepted "
                     f"{[float(s['accepted']) for s in stats_seen]} (the same bits as eager)")
        lines.append(f"trust-region graph phase {kind}, graphs against eager: NormObs(HalfCheetah) E={TR_E} T={TR_T}, "
                     f"{GRAPH_CALLS} rollouts, each one update of {TR_CRITIC_ITERS} critic steps; weights, the critic's "
                     f"Adam state (count {int(count)}) and every stat bit-identical, max |diff| {worst:.3e}{extra}; "
                     f"replays and capture s { {n: (r, round(c, 3)) for n, (r, c) in graphs.items()} }; pool "
                     f"{trainer.graph_pool.memory_bytes() / 2**20:.1f} MiB")

    algo, ts, coll = build_ppo(torch, "HalfCheetah", MJ_E, ppo_init=True, sde=True, sigma_init=SDE_SIGMA_INIT,
                               action_bound_method="clip")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    ecs = copy.deepcopy(cstate)
    egen = torch.Generator(device="cuda")
    egen.set_state(gen.get_state())
    trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(
        batch_size=MJ_BATCH, collection_step_num_env_steps=SDE_GRAPH_T, update_step_num_repetitions=1, verbose=False))
    launches, outs, ended = {}, {}, 0
    for side in ("graph", "eager"):
        before = counters.snapshot()
        outs[side] = []
        for _ in range(GRAPH_CALLS):
            if side == "graph":
                out = trainer.collect_chunk(ts, cstate, None, gen, SDE_GRAPH_T, keep_rollout=True)
            else:
                out = coll.rollout(ts, ecs, None, egen, SDE_GRAPH_T, keep_rollout=True)
            outs[side].append(out.map(torch.clone))
        torch.cuda.synchronize()
        after = counters.snapshot()
        launches[side] = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    for g, e in zip(outs["graph"], outs["eager"]):
        if not all(torch.equal(a, b) for a, b in zip(_leaves(g), _leaves(e))):
            raise AssertionError("gSDE graph phase: a collect chunk differs from the eager chunk")
        ended += int(g.done.sum())
    if not all(torch.equal(a, b) for a, b in zip(_leaves(cstate), _leaves(ecs))):
        raise AssertionError("gSDE graph phase: the collect states (the carried noise and counts) differ")
    replays = {gr.name.split()[0]: gr.replays for gr in trainer.graph_pool.graphs}
    if launches["graph"] != launches["eager"] or replays != {"collect_chunk": GRAPH_CALLS - 1} or not ended:
        raise AssertionError(f"gSDE graph phase: launches {launches}, replays {replays}, {ended} episode ends")
    torch.backends.cudnn.deterministic = deterministic
    lines.append(f"gSDE graph phase, graphs against eager: PPO+gSDE on NormObs(HalfCheetah) E={MJ_E}, {GRAPH_CALLS} "
                 f"collect chunks of T={SDE_GRAPH_T} (the refresh, fresh noise each step, the reset at {ended} episode "
                 f"ends); rollouts, carried noise and counts bit-identical, max |diff| 0.000e+00; launches "
                 f"{launches['graph']} as eager; {_graph_report(trainer.graph_pool, 1)}")
    return lines


def trust_region_path(torch, name: str):
    """``examples/mujoco/mujoco_{npg,trpo}.py``'s defaults through ``OnPolicyTrainer`` and its collect,
    update and test graphs: 16 envs of ``NormObs(HalfCheetah())``, T 64, one update per rollout over its
    1,024 rows (batch 16,384), 20 critic steps, 10 test episodes on 10 envs with frozen statistics;
    the depth cut from 30 epochs of 100,000 steps to 1. Checks: one ``physics_fused`` launch per vector
    step, train and test; every logged loss and the KL finite; the step and Adam counts. Prints the
    relative residual ``|F s - g| / |g|`` of the first rollout's conjugate-gradient solution (its eager
    warm-up) and, for TRPO, the step fractions and the share of updates accepted. Returns
    ({kernel: launches}, report lines)."""
    import numpy as np

    from tianshou_tpu_torch.algorithm.modelfree.npg import _flat
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.wrappers import NormObs
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    kind = name.split("_")[0]
    algo, ts, train_c = build_trust_region(torch, kind, TR_E)
    test_c = DeviceCollector(VectorDeviceEnv(NormObs(train_c.venv.env.env, update_stats=False), 10, device="cuda"),
                             algo, None)
    tests = []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    trainer = OnPolicyTrainer(algo, train_c, test_c, OnPolicyTrainerParams(
        max_epochs=1, epoch_num_steps=TR_EPOCH_STEPS, test_step_num_episodes=10, batch_size=TR_BATCH,
        collection_step_num_env_steps=TR_T, update_step_num_repetitions=1, compute_score_fn=score, verbose=False))
    handoffs = _rms_handoff_check(torch, trainer, f"{name} path")
    logged = []
    log_update = trainer._log_update
    trainer._log_update = lambda stats: (logged.append({k: float(v) for k, v in stats.items()}), log_update(stats))
    residual = {}
    natural_step = algo._natural_step

    def first_residual(actor, mb):
        s, obj, shs = natural_step(actor, mb)
        if not residual:  # the first rollout's update runs eagerly (the program's warm-up)
            params = list(actor.parameters())
            g = _flat(torch.autograd.grad(algo._actor_objective(actor, mb), params))
            grad_kl = _flat(torch.autograd.grad(algo._kl_to_old(actor, mb), params, create_graph=True))
            fs = _flat(torch.autograd.grad(grad_kl @ s, params)) + algo.damping * s
            residual.update(rel=(fs - g).norm() / g.norm(), shs=shs.clone(), n=g.numel())
        return s, obj, shs

    algo._natural_step = first_residual
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res = trainer.run(ts, torch.Generator(device="cuda").manual_seed(SEED))
    del algo._natural_step
    launches = _launches(gather, sumtree, physics_fused)
    test_steps = sum(s.n_collected_steps for s in tests) // 10
    if launches != {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0,
                    "physics_fused": res.env_step // TR_E + test_steps}:
        raise AssertionError(f"{name} path: kernel launches {launches} for {res.env_step // TR_E} train and "
                             f"{test_steps} test vector steps")
    n_rollouts = res.env_step // (TR_E * TR_T)
    if len(logged) != n_rollouts or not all(np.isfinite(v) for d in logged for v in d.values()):
        raise AssertionError(f"{name} path: {len(logged)} logged updates for {n_rollouts} rollouts, or a non-finite stat")
    if len(tests) != 1 or tests[0].n_collected_episodes != 10 or not np.isfinite(tests[0].returns).all():
        raise AssertionError(f"{name} path: test phases {[(s.n_collected_episodes, s.returns) for s in tests]}")
    if not int(ts.step) == res.gradient_step == n_rollouts or int(_adam_count(ts)) != n_rollouts * TR_CRITIC_ITERS:
        raise AssertionError(f"{name} path: step {int(ts.step)}, gradient_step {res.gradient_step}, Adam count "
                             f"{int(_adam_count(ts))} for {n_rollouts} rollouts")
    t = res.timing
    graphs = {g.name.split()[0]: g for g in trainer.graph_pool.graphs}
    mean = {k: float(np.mean([d[k] for d in logged])) for k in ("loss", "vf_loss", "kl")}
    extra = ""
    if kind == "trpo":
        fracs = [d["step_frac"] for d in logged]
        extra = (f"; step_frac mean {np.mean(fracs):.4f} (min {min(fracs):.4f}, by value "
                 f"{ {round(f, 4): fracs.count(f) for f in sorted(set(fracs))} }), accepted in "
                 f"{sum(d['accepted'] for d in logged):.0f} of {len(logged)} updates "
                 f"(share {np.mean([d['accepted'] for d in logged]):.4f})")
    return launches, [
        f"{name} path: NormObs(HalfCheetah) E={TR_E} T={TR_T} batch={TR_BATCH} (one minibatch of {TR_E * TR_T}) "
        f"critic steps {TR_CRITIC_ITERS}; {res.epochs} epoch of {TR_EPOCH_STEPS} steps ({n_rollouts} rollouts): test "
        f"reward {float(tests[0].returns.mean()):.2f} (finite; no threshold at this depth); physics_fused launches "
        f"{launches['physics_fused']} = {res.env_step // TR_E} train + {test_steps} test vector steps; the first update's "
        f"conjugate gradient ({algo.cg_iters} iterations over {residual['n']} actor parameters): relative residual "
        f"|F s - g| / |g| {float(residual['rel']):.4e}, sHs {float(residual['shs']):.4f}; logged means: loss "
        f"{mean['loss']:.4f} vf_loss {mean['vf_loss']:.4f} kl {mean['kl']:.5f} (every stat finite){extra}; pooled "
        f"statistics handed to the test envs at {len(handoffs)} phase",
        f"{name} path: wall {res.train_time:.2f} s (collect {t['collect']:.2f}, update {t['update']:.2f}, test "
        f"{t['test']:.2f}); ms per rollout update {t['update'] / n_rollouts * 1e3:.3f} (captures included); train "
        f"env_steps_per_s {res.env_step / (t['collect'] + t['update']):.1f} (collect and update time only); capture s "
        f"{ {n: round(g.capture_s, 3) for n, g in graphs.items() if g.capture_s is not None} }; "
        f"{_graph_report(trainer.graph_pool, 2)}",
    ] + _replay_update(torch, graphs["update_rollout"], name)


def _replay_update(torch, program, name: str) -> list[str]:
    """A trainer's update graph replayed ``PCP_REPLAYS`` times alone after its run: its device ms."""
    times = []
    for _ in range(PCP_REPLAYS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        program()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return [f"{name} path, the update graph replayed alone ({PCP_REPLAYS} times after the run): "
            f"{statistics.median(times):.3f} ms of device time per rollout update (median; "
            f"{', '.join(f'{x:.3f}' for x in times)})"]


def trpo_cartpole_path(torch):
    """TRPO on CartPole as ``tests/test_trust_region.py:26-55`` trains it, through ``OnPolicyTrainer``
    and its collect, update and test graphs: ``DiscreteActor((64, 64))`` and ``DiscreteCritic((64, 64))``,
    Adam 1e-3, 16 train and 10 test envs, T 128, batch 1,024, at most 15 epochs of 10,000 steps; it must
    reach ``CP_THRESHOLD``. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.algorithm.modelfree.trpo import TRPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    torch.manual_seed(SEED)
    env = CartPole()
    algo = TRPO(actor=DiscreteActor((64, 64), 2, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
                action_space=env.action_space, optim=AdamOptimizerFactory(lr=1e-3), gamma=0.99, gae_lambda=0.95,
                deterministic_eval=True)
    tests, fracs = [], []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    trainer = OnPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, TCP_E, device="cuda"), algo, None),
                              DeviceCollector(VectorDeviceEnv(env, CP_E, device="cuda"), algo, None),
                              OnPolicyTrainerParams(
                                  max_epochs=TCP_EPOCHS, epoch_num_steps=TCP_EPOCH_STEPS, test_step_num_episodes=10,
                                  batch_size=TCP_BATCH, collection_step_num_env_steps=TCP_T,
                                  update_step_num_repetitions=1, stop_fn=lambda r: r >= CP_THRESHOLD,
                                  compute_score_fn=score, verbose=False))
    log_update = trainer._log_update
    trainer._log_update = lambda stats: (fracs.append(float(stats.step_frac)), log_update(stats))
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res = trainer.run(algo.init("cuda"), torch.Generator(device="cuda").manual_seed(SEED))
    launches = _launches(gather, sumtree, physics_fused)
    if not res.best_reward >= CP_THRESHOLD:
        raise AssertionError(f"trpo_cartpole path: best test reward {res.best_reward} after {res.epochs} epochs, below "
                             f"the threshold {CP_THRESHOLD}")
    graphs = {g.name.split()[0]: g for g in trainer.graph_pool.graphs}
    if any(launches.values()) or sorted(graphs) != ["collect_chunk", "test_chunk", "update_rollout"]:
        raise AssertionError(f"trpo_cartpole path: launches {launches}, programs {sorted(graphs)}")
    t = res.timing
    return launches, [
        f"trpo_cartpole path: best test reward {res.best_reward:.1f} (threshold {CP_THRESHOLD}) after {res.epochs} epochs "
        f"(test reward by epoch {[round(float(s.returns.mean()), 1) for s in tests]}); env_steps {res.env_step} "
        f"gradient_steps {res.gradient_step}; step_frac mean {sum(fracs) / len(fracs):.4f} over {len(fracs)} rollouts; "
        f"wall {res.train_time:.2f} s (collect {t['collect']:.2f}, update {t['update']:.2f}, test {t['test']:.2f}); "
        f"train env_steps_per_s {res.env_step / (t['collect'] + t['update']):.1f} (captures included); capture s "
        f"{ {n: round(g.capture_s, 3) for n, g in graphs.items() if g.capture_s is not None} }; "
        f"{_graph_report(trainer.graph_pool, 2)}",
    ]


def ppo_mlp_cartpole_path(torch):
    """``bench.py:312-350`` ``bench_mlp_ppo`` in the port: PPO on CartPole at E = ``MLP_E``, one program of
    ``MLP_T`` collect steps (``keep_rollout=True``) and then ``update_rollout`` (``MLP_REPEAT`` passes of
    batch ``MLP_BATCH``) as ONE CUDA graph, called for an eager warm-up, a capture, then ``MLP_ITERS`` timed
    replays. No kernel of the port runs. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    torch.manual_seed(SEED)
    env = CartPole()
    algo = PPO(actor=DiscreteActor((64, 64), 2, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
               action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5),
               deterministic_eval=True)
    ts = algo.init("cuda")
    coll = DeviceCollector(VectorDeviceEnv(env, MLP_E, device="cuda"), algo, None)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    pool = GraphPool("cuda")

    def megastep():
        out = coll.rollout(ts, cstate, None, gen, MLP_T, keep_rollout=True)
        return out, algo.update_rollout(ts, out.rollout, gen, MLP_REPEAT, MLP_BATCH)[1]

    program = Graphed(megastep, pool, (gen,), name="mlp_ppo_megastep")
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    walls, device_ms = [], []
    for _ in range(2 + MLP_ITERS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out, stats = program()
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        device_ms.append(a.elapsed_time(b))
    launches = _launches(gather, sumtree, physics_fused)
    n_mb = algo.minibatch_shape(MLP_T * MLP_E, MLP_BATCH)[0]
    if any(launches.values()) or program.replays != 1 + MLP_ITERS:
        raise AssertionError(f"ppo_mlp_cartpole path: launches {launches}, {program.replays} replays")
    if not all(bool(torch.isfinite(v).all()) for v in stats.values()) or int(ts.step) != (2 + MLP_ITERS) * MLP_REPEAT * n_mb:
        raise AssertionError(f"ppo_mlp_cartpole path: stats {stats}, step {int(ts.step)}")
    wall, dev = statistics.median(walls[2:]), statistics.median(device_ms[2:])
    episodes = int(out.done.sum())
    return launches, [
        f"ppo_mlp_cartpole path: CartPole E={MLP_E} T={MLP_T} repeat={MLP_REPEAT} batch={MLP_BATCH} ({n_mb} minibatches); "
        f"{2 + MLP_ITERS} megasteps (eager warm-up, capture + replay, {MLP_ITERS} timed replays); no kernel of the port; "
        f"graph replays: env_steps_per_s {MLP_T * MLP_E / wall:.1f} ms_per_megastep {wall * 1e3:.3f} wall, {dev:.3f} "
        f"device (eager warm-up {walls[0] * 1e3:.1f} ms); episodes ended in the last megastep {episodes}; "
        f"{_graph_report(pool, 1)}; last stats { {k: round(float(v), 5) for k, v in stats.items()} }",
    ]


# ---------------------------------------------------------------------------
# the host env path, the recurrent Q path, HER and the cached buffer
# ---------------------------------------------------------------------------
DEV = "cuda"  # the device of these phases' policies, buffers and updates (the host envs are numpy)
WAIT_S = 120.0  # the longest any phase waits for one env worker's reply
# host_dqn_pixels (examples/atari/_runner.py:_run_offpolicy_host): 16 train and 10 test envs of the scripted Atari
# under wrap_deepmind (the test envs without episodic lives and reward clipping, as the reference's), a
# 100,000-frame uint8 ring (stack 4, newest frame only, obs_next from the next row), DQN over DQNet at lr 1e-4, n 3,
# target sync 500, batch 32, T 10, 0.1 updates per env step; the prefill cut from 50,000 steps to HD_PREFILL and the
# epoch from 100,000 steps to HD_EPOCH_STEPS
HD_E, HD_TEST_E, HD_BUFFER, HD_T, HD_BATCH, HD_PREFILL, HD_EPOCH_STEPS = 16, 10, 100_000, 10, 32, 2_000, 3_200
ATARI_FRAMES = 400  # the scripted Atari's frames per game, 100 agent steps under MaxAndSkipEnv
HD_SPLIT_STEPS = 20  # vector steps of the instrumented collect that splits a step's time
# recurrent_dqn_pomdp (tests/test_recurrent.py:62-92): MaskVelocity(CartPole), RecurrentQNet(64, 2), a 20,000-row
# replay of 10 rings with stack 4, n 3, target sync 320, batch 64, T 10, 0.2 updates per env step, a 1,000-step
# prefill, eps 0.3 annealed to 0.05 over 40,000 steps, at most 12 epochs of 5,000 steps; it must reach 100
RQ_E, RQ_BUFFER, RQ_STACK, RQ_BATCH, RQ_T, RQ_UPS, RQ_PREFILL = 10, 20_000, 4, 64, 10, 0.2, 1_000
RQ_EPOCHS, RQ_EPOCH_STEPS, RQ_THRESHOLD = 12, 5_000, 100.0
# her_ddpg_goal_reach (tests/test_her.py:110-145): GoalReach(1.0, 0.05, 0.05, 60), 128x128 goal nets, HER over a
# 50,000-row replay of 8 rings (horizon 60, future_k 8), batch 128, T 8, 0.25 updates per env step, a 2,000-step
# prefill of the policy, 20 test episodes over 10 envs, at most 8 epochs of 4,000 steps; the median best test reward
# of HER_SEEDS must reach -20
HER_E, HER_TEST_E, HER_BUFFER, HER_BATCH, HER_T, HER_UPS, HER_PREFILL = 8, 10, 50_000, 128, 8, 0.25, 2_000
HER_EPOCHS, HER_EPOCH_STEPS, HER_THRESHOLD, HER_SEEDS = 8, 4_000, -20.0, (0, 1, 2)


class HostDiscrete:
    """A host action space of ``n`` actions; ``sample`` draws from its own generator."""

    def __init__(self, n: int, seed: int = 0) -> None:
        self.n = n
        self._rng = np.random.default_rng(seed)

    def sample(self) -> int:
        return int(self._rng.integers(self.n))


class NumpyCartPole:
    """Gymnasium's CartPole-v1 in numpy (its constants, its Euler step in float64, its reset draw of
    U(-0.05, 0.05) from the seeded generator, its 500-step time limit) with the Gymnasium API, so that this
    script needs no gymnasium."""

    def __init__(self) -> None:
        self.action_space = HostDiscrete(2)
        self._rng = np.random.default_rng()
        self.theta_threshold = 12 * 2 * 3.141592653589793 / 360
        self.state = None
        self.t = 0

    def reset(self, seed=None, **kw):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(-0.05, 0.05, 4)
        self.t = 0
        return self.state.astype(np.float32), {}

    def step(self, action):
        import math

        x, x_dot, theta, theta_dot = self.state
        force = 10.0 if int(action) == 1 else -10.0
        costheta, sintheta = math.cos(theta), math.sin(theta)
        temp = (force + 0.05 * theta_dot**2 * sintheta) / 1.1
        thetaacc = (9.8 * sintheta - costheta * temp) / (0.5 * (4.0 / 3.0 - 0.1 * costheta**2 / 1.1))
        xacc = temp - 0.05 * thetaacc * costheta / 1.1
        x, x_dot = x + 0.02 * x_dot, x_dot + 0.02 * xacc
        theta, theta_dot = theta + 0.02 * theta_dot, theta_dot + 0.02 * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self.t += 1
        terminated = bool(abs(x) > 2.4 or abs(theta) > self.theta_threshold)
        return self.state.astype(np.float32), 1.0, terminated, self.t >= 500, {}

    def close(self) -> None:
        pass


class _Lives:
    def __init__(self, env) -> None:
        self.env = env

    def lives(self) -> int:
        return self.env.lives


class ScriptedAtari:
    """A raw-frame Atari game in numpy with the ALE surface that the DeepMind wrappers read (the model is
    ``tests/test_atari_wrappers.py:37`` ``FakeAtari``): ``210x160x3`` uint8 frames, ``ale.lives()``, the
    action meanings NOOP, FIRE, RIGHT and LEFT, a reset seeded by ``reset(seed=...)``. A ball falls and a
    paddle that RIGHT and LEFT move catches it: a catch scores 1, a miss costs one of 3 lives; a game
    ends with the lives or after ``ATARI_FRAMES`` frames."""

    def __init__(self) -> None:
        self.action_space = HostDiscrete(4)
        self.unwrapped = self
        self.ale = _Lives(self)
        self._rng = np.random.default_rng()
        self.lives = 3

    def get_action_meanings(self) -> list[str]:
        return ["NOOP", "FIRE", "RIGHT", "LEFT"]

    def _serve(self) -> None:
        self.ball = [0, int(self._rng.integers(12, 148))]

    def _frame(self):
        f = np.zeros((210, 160, 3), np.uint8)
        f[..., 2] = 40
        f[186:190, self.paddle - 10:self.paddle + 10] = 200
        by, bx = self.ball
        f[by:by + 4, bx - 2:bx + 2] = 255
        return f

    def reset(self, seed=None, **kw):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.t, self.lives, self.paddle = 0, 3, 80
        self._serve()
        return self._frame(), {}

    def step(self, action):
        self.t += 1
        a = int(action)
        self.paddle = min(max(self.paddle + (4 if a == 2 else -4 if a == 3 else 0), 12), 148)
        self.ball[0] += 6
        reward = 0.0
        if self.ball[0] >= 186:
            if abs(self.ball[1] - self.paddle) <= 12:
                reward = 1.0
            else:
                self.lives -= 1
            self._serve()
        return self._frame(), reward, self.lives <= 0, self.t >= ATARI_FRAMES, {}

    def close(self) -> None:
        pass


def pixel_env(test: bool = False):
    """The scripted Atari under ``wrap_deepmind``: ``[4, 84, 84]`` uint8 observations."""
    from tianshou_tpu_torch.env.atari import wrap_deepmind

    return wrap_deepmind(ScriptedAtari(), episode_life=not test, clip_rewards=not test)


def pixel_test_env():
    return pixel_env(test=True)


def _host_launches():
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree

    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    return lambda: _launches(gather, sumtree, physics_fused)


def _pixel_example(torch):
    from tianshou_tpu_torch.data.batch import Batch

    frame = torch.zeros((84, 84), dtype=torch.uint8)
    return Batch(obs=frame, act=torch.tensor(0), rew=torch.tensor(0.0), terminated=torch.tensor(False),
                 truncated=torch.tensor(False), obs_next=frame.clone())


def _pixel_buffer(size: int):
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer

    return VectorReplayBuffer(size, HD_E, stack_num=4, save_only_last_obs=True, ignore_obs_next=True)


def host_dqn(torch, eps: float = 1.0):
    """``examples/atari/atari_dqn.py``'s DQN over ``DQNet(4)`` on ``DEV``: (algo, train state)."""
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.env.core import Discrete
    from tianshou_tpu_torch.models.atari import DQNet

    torch.manual_seed(SEED)
    algo = DQN(model=DQNet(action_dim=4), action_space=Discrete(4), optim=AdamOptimizerFactory(lr=1e-4), gamma=0.99,
               n_step_return_horizon=3, target_update_freq=500, eps_training=eps, eps_inference=TEST_EPS)
    return algo, algo.init(DEV)


def host_ring_identity(torch) -> list[str]:
    """One chunk (T steps of every env) of the pixel path at eps 0 from one train state and one seed,
    collected over ``DummyVectorEnv``, ``SubprocVectorEnv`` and ``ShmemVectorEnv``: the rings, cursors
    and episode statistics must be bit-identical."""
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.shmem import ShmemVectorEnv
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv, SubprocVectorEnv

    algo, ts = host_dqn(torch, eps=0.0)
    rings, stats = {}, {}
    for name, cls in (("dummy", DummyVectorEnv), ("subproc", SubprocVectorEnv), ("shmem", ShmemVectorEnv)):
        venv = cls([pixel_env] * HD_E, **({} if name == "dummy" else {"recv_timeout": WAIT_S}))
        try:
            buffer = _pixel_buffer(HD_E * 32)
            coll = HostCollector(venv, algo, buffer, device=DEV)
            coll.reset(seed=SEED)
            coll.reset_buffer(_pixel_example(torch))
            st = coll.collect(ts, torch.Generator(device=DEV).manual_seed(SEED), n_step=HD_T * HD_E)
            bs = coll.buf_state
            rings[name] = [bs.cursor, bs.size, bs.last_idx, *bs.data.values()]
            stats[name] = (st.n_collected_episodes, st.returns.tolist(), st.lens.tolist())
        finally:
            venv.close()
    for name in ("subproc", "shmem"):
        if stats[name] != stats["dummy"] or not all(torch.equal(a, b) for a, b in zip(rings[name], rings["dummy"])):
            raise AssertionError(f"host_dqn_pixels: the {name} venv's rings differ from the dummy venv's")
    obs = rings["dummy"][3]
    return [f"host_dqn_pixels, venvs: one chunk of {HD_T} steps x {HD_E} envs at eps 0 from one train state: Dummy, "
            f"Subproc and Shmem rings {tuple(obs.shape)} uint8 bit-identical ({int(rings['dummy'][1].sum())} rows, "
            f"{stats['dummy'][0]} episodes)"]


def _step_split(torch, coll, ts, gen, steps: int) -> str:
    """An instrumented collect of ``steps`` vector steps: the time in the forward with its action copy
    to the host (``_act``, which synchronises), in the envs (``venv.step``), and the rest (the observations'
    copy to the device, the buffer's insert, the books). Returns a report fragment."""
    spent = {"act": 0.0, "env": 0.0}
    act, step = coll._act, coll.venv.step

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[key] += time.perf_counter() - t0
            return out
        return run

    coll._act, coll.venv.step = timed("act", act), timed("env", step)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coll.collect(ts, gen, n_step=steps * len(coll.venv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del coll._act
        coll.venv.step = step
    per = 1e3 / steps
    return (f"a vector step of {len(coll.venv)} envs {wall * per:.2f} ms: envs {spent['env'] * per:.2f} ms, forward with "
            f"the action copy {spent['act'] * per:.2f} ms, observation copy to the device, buffer insert and books "
            f"{(wall - spent['env'] - spent['act']) * per:.2f} ms ({steps} steps)")


def host_dqn_pixels_path(torch, overlap: bool):
    """The twin of ``examples/atari/_runner.py:_run_offpolicy_host`` on the card: ``HostOffPolicyTrainer``
    over a ``HostCollector`` of ``DummyVectorEnv`` (with ``overlap_updates``: the chunk's updates launched
    from the step hook), the random prefill, one epoch, a test phase over 10 envs. Exactly 2
    ``gather_rows`` per update and no other kernel. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv
    from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer, OffPolicyTrainerParams

    name = "host_dqn_pixels" + ("_overlap" if overlap else "")
    algo, ts = host_dqn(torch)
    buffer = _pixel_buffer(HD_BUFFER)
    bs = buffer.init(_pixel_example(torch), device=DEV)
    venvs = [DummyVectorEnv([pixel_env] * HD_E), DummyVectorEnv([pixel_test_env] * HD_TEST_E)]
    try:
        tc = HostCollector(venvs[0], algo, buffer, device=DEV)
        ec = HostCollector(venvs[1], algo, None, device=DEV)
        tests = []

        def score(stats) -> float:
            tests.append(stats)
            return float(stats.returns.mean())

        params = OffPolicyTrainerParams(
            max_epochs=1, epoch_num_steps=HD_EPOCH_STEPS, test_step_num_episodes=TEST_EPISODES, batch_size=HD_BATCH,
            collection_step_num_env_steps=HD_T, update_per_step=0.1, start_steps=HD_PREFILL, compute_score_fn=score,
            train_fn=lambda epoch, step: {"eps_training": max(0.05, 1.0 - step / 1_000_000)}, verbose=False, seed=SEED,
            overlap_updates=overlap)
        trainer = HostOffPolicyTrainer(algo, tc, ec, buffer, params)
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        read = _host_launches()
        res = trainer.run(ts, bs, gen)
        torch.cuda.synchronize()
        launches = read()
        n_updates = round(0.1 * HD_T * HD_E)
        chunks = HD_EPOCH_STEPS // (HD_T * HD_E)
        if res.gradient_step != chunks * n_updates or int(ts.step) != res.gradient_step:
            raise AssertionError(f"{name}: {res.gradient_step} updates ({int(ts.step)} on the device), expected "
                                 f"{chunks * n_updates}")
        expect = {"gather_rows": 2 * res.gradient_step, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": 0}
        if launches != expect:
            raise AssertionError(f"{name}: kernel launches {launches} for {res.gradient_step} updates, expected {expect}")
        if len(tests) != 1 or tests[0].n_collected_episodes != TEST_EPISODES or not np.isfinite(tests[0].returns).all():
            raise AssertionError(f"{name}: the test phase returned {[t.n_collected_episodes for t in tests]} episodes")
        rows = int(tc.buf_state.size.sum())
        if rows != HD_PREFILL + HD_EPOCH_STEPS or not bool(torch.isfinite(res.last_chunk_stats.loss).all()):
            raise AssertionError(f"{name}: {rows} rows stored, loss {res.last_chunk_stats.loss}")
        graphs = {g.name: g for g in trainer.graph_pool.graphs}
        t = res.timing
        train_s = t["collect"] + t["update"]
        split = _step_split(torch, tc, ts, gen, HD_SPLIT_STEPS)
    finally:
        for v in venvs:
            v.close()
    return launches, [
        f"{name} path: E={HD_E} T={HD_T} ring uint8 {tuple(bs.data.obs.shape)} ({bs.data.obs.numel() / 1e9:.3f} GB); "
        f"prefill {HD_PREFILL} in {t['prefill']:.2f} s; epoch of {HD_EPOCH_STEPS} steps and {res.gradient_step} updates: "
        f"collect {t['collect']:.2f} s, update {t['update']:.2f} s (with overlap_updates the updates run inside the "
        f"collect and update is what the env steps did not hide); env_steps_per_s {HD_EPOCH_STEPS / train_s:.1f} "
        f"(collect and update); test {t['test']:.2f} s for {TEST_EPISODES} episodes (returns mean "
        f"{tests[0].returns.mean():.2f}, length mean {tests[0].lens.mean():.1f}); gather_rows {launches['gather_rows']} "
        f"= 2 per update; programs and captures "
        f"{ {n: (g.replays, None if g.capture_s is None else round(g.capture_s, 2)) for n, g in graphs.items()} }",
        f"{name} path, host/device split: {split}",
    ]


def pipelined_check(torch) -> list[str]:
    """``PipelinedHostCollector`` on the card over 4 ``SubprocVectorEnv`` CartPole twins
    (``tests/test_host_env.py:175-205``): every ring advanced by exactly T, ``obs_next`` of a step the
    next step's ``obs`` inside an episode, integer actions, consistent episode books; then at eps 0
    its rings against the sequential collector's, bit-identical."""
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.data.pipelined_collector import PipelinedHostCollector
    from tianshou_tpu_torch.env.core import Discrete
    from tianshou_tpu_torch.env.venvs import SubprocVectorEnv
    from tianshou_tpu_torch.models.mlp import Net

    E, steps = 4, 15
    torch.manual_seed(SEED)
    algo = DQN(model=Net((32, 32), 2, input_dim=4), action_space=Discrete(2), optim=AdamOptimizerFactory(lr=1e-3),
               gamma=0.97, target_update_freq=16, eps_training=0.2)
    ts = algo.init(DEV)
    ex = Batch(obs=torch.zeros(4), act=torch.tensor(0), rew=torch.tensor(0.0), terminated=torch.tensor(False),
               truncated=torch.tensor(False), obs_next=torch.zeros(4))
    rings = []
    venvs = [SubprocVectorEnv([NumpyCartPole] * E, recv_timeout=WAIT_S) for _ in range(3)]
    try:
        for k, (cls, eps) in enumerate(((PipelinedHostCollector, 0.2), (PipelinedHostCollector, 0.0),
                                        (HostCollector, 0.0))):
            ts.hparams["eps_training"].fill_(eps)
            col = cls(venvs[k], algo, VectorReplayBuffer(E * 100, E), device=DEV)
            col.reset(seed=3)
            col.reset_buffer(ex)
            stats = col.collect(ts, torch.Generator(device=DEV).manual_seed(1), n_step=E * steps)
            bs = col.buf_state
            if k == 0:
                obs, obs_next, done = (bs.data[key].cpu().numpy() for key in ("obs", "obs_next", "done"))
                inside = all(np.array_equal(obs_next[e, i], obs[e, i + 1]) for e in range(E) for i in range(steps - 1)
                             if not done[e, i])
                if (stats.n_collected_steps != E * steps or bs.size.tolist() != [steps] * E or not inside
                        or bs.data.act.dtype != torch.int64
                        or not stats.n_collected_episodes == len(stats.returns) == len(stats.lens)):
                    raise AssertionError("pipelined collector: its rings or books are off")
            else:
                rings.append([bs.cursor, bs.size, *bs.data.values()])
    finally:
        for v in venvs:
            v.close()
    if not all(torch.equal(a, b) for a, b in zip(*rings)):
        raise AssertionError("pipelined collector: its rings differ from the sequential collector's at eps 0")
    return [f"pipelined collector on the card ({E} Subproc CartPole twins, {steps} steps): rings advanced by {steps} each, "
            f"obs_next chained to the next obs, integer actions, consistent books; at eps 0 bit-identical to the "
            f"sequential collector's rings"]


def host_ppo_cartpole_path(torch):
    """PPO on CartPole at ``tests/test_onpolicy.py:17-53``'s settings through ``HostOnPolicyTrainer`` over
    ``VectorEnvNormObs(SubprocVectorEnv(16 numpy CartPole twins))``; the test venv (10 envs) reads the
    train venv's ``RunningMeanStd``, frozen (``examples/mujoco/_runner.py:242-246``). It must reach
    ``CP_THRESHOLD`` within the reference test's 20 epochs. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.core import Discrete
    from tianshou_tpu_torch.env.venvs import SubprocVectorEnv, VectorEnvNormObs
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
    from tianshou_tpu_torch.trainer.trainer import HostOnPolicyTrainer, OnPolicyTrainerParams

    torch.manual_seed(SEED)
    algo = PPO(actor=DiscreteActor((64, 64), 2, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
               action_space=Discrete(2), optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5), gamma=0.99,
               gae_lambda=0.95, eps_clip=0.2, ent_coef=0.01, deterministic_eval=True)
    train = VectorEnvNormObs(SubprocVectorEnv([NumpyCartPole] * PCP_E, recv_timeout=WAIT_S))
    test = VectorEnvNormObs(SubprocVectorEnv([NumpyCartPole] * CP_E, recv_timeout=WAIT_S), update_obs_rms=False)
    test.set_obs_rms(train.get_obs_rms())
    try:
        tests = []

        def score(stats) -> float:
            tests.append(stats)
            return float(stats.returns.mean())

        params = OnPolicyTrainerParams(
            max_epochs=PCP_EPOCHS, epoch_num_steps=PCP_EPOCH_STEPS, test_step_num_episodes=10, batch_size=PCP_BATCH,
            collection_step_num_env_steps=PCP_T, update_step_num_repetitions=PCP_REPEAT,
            stop_fn=lambda r: r >= CP_THRESHOLD, compute_score_fn=score, verbose=False, seed=SEED)
        trainer = HostOnPolicyTrainer(algo, HostCollector(train, algo, None, device=DEV),
                                      HostCollector(test, algo, None, device=DEV), params)
        read = _host_launches()
        res = trainer.run(algo.init(DEV), torch.Generator(device=DEV).manual_seed(SEED))
        launches = read()
        rms = train.get_obs_rms()
    finally:
        train.close()
        test.close()
    if not res.best_reward >= CP_THRESHOLD:
        raise AssertionError(f"host_ppo_cartpole: best test reward {res.best_reward} after {res.epochs} epochs, below "
                             f"{CP_THRESHOLD}")
    if any(launches.values()) or int(res.train_state.step) != res.gradient_step:
        raise AssertionError(f"host_ppo_cartpole: launches {launches}, steps {res.gradient_step} / "
                             f"{int(res.train_state.step)}")
    if test.get_obs_rms() is not rms or not rms.count > res.env_step:
        raise AssertionError("host_ppo_cartpole: the test venv does not read the train venv's statistics")
    t = res.timing
    graphs = {g.name.split()[0]: (g.replays, None if g.capture_s is None else round(g.capture_s, 2))
              for g in trainer.graph_pool.graphs}
    return launches, [
        f"host_ppo_cartpole path: best test reward {res.best_reward:.1f} (threshold {CP_THRESHOLD}) after {res.epochs} "
        f"epochs (test reward by epoch {[round(float(s.returns.mean()), 1) for s in tests]}); env_steps {res.env_step} "
        f"gradient_steps {res.gradient_step}; collect {t['collect']:.2f} s, update {t['update']:.2f} s, test "
        f"{t['test']:.2f} s; train env_steps_per_s {res.env_step / (t['collect'] + t['update']):.1f}; the train venv's "
        f"RunningMeanStd ({rms.count:.0f} rows) read frozen by the test venv; programs {graphs}; no kernel"]


def mask_velocity_cartpole():
    """``tests/test_recurrent.py:21`` ``MaskVelocity(CartPole())``: only the position and the angle."""
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import Box, Env

    class MaskVelocity(Env):
        def __init__(self, env) -> None:
            self.env = env
            self.observation_space = Box(low=[-4.8, -0.5], high=[4.8, 0.5])
            self.action_space = env.action_space
            self.max_episode_steps = env.max_episode_steps

        def reset(self, num_envs, generator, device):
            s, obs = self.env.reset(num_envs, generator, device)
            return s, obs[:, 0::2]  # a slice: an index list would be a host-to-device copy in a graph

        def step(self, state, action, generator):
            s = self.env.step(state, action, generator)
            return s._replace(obs=s.obs[:, 0::2])

    return MaskVelocity(CartPole())


def build_recurrent(torch):
    """(algo, buffer, train collector, test collector) of the recurrent POMDP path on ``DEV``."""
    from tianshou_tpu_torch.algorithm.modelfree.dqn import RecurrentDQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.recurrent import RecurrentQNet

    torch.manual_seed(SEED)
    env = mask_velocity_cartpole()
    algo = RecurrentDQN(model=RecurrentQNet(64, 2, input_dim=2), action_space=env.action_space,
                        optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=3,
                        target_update_freq=320, eps_training=0.3)
    buffer = VectorReplayBuffer(RQ_BUFFER, RQ_E, stack_num=RQ_STACK)
    return (algo, buffer, DeviceCollector(VectorDeviceEnv(env, RQ_E, device=DEV), algo, buffer),
            DeviceCollector(VectorDeviceEnv(env, CP_E, device=DEV), algo, None))


def _vector_example(torch, obs, act):
    from tianshou_tpu_torch.data.batch import Batch

    return Batch(obs=obs, act=act, rew=torch.tensor(0.0), terminated=torch.tensor(False),
                 truncated=torch.tensor(False), obs_next=obs.map(torch.clone) if hasattr(obs, "map") else obs.clone())


def offpolicy_graph_check(torch, name: str, algo, buffer, example, coll, T_: int, batch: int,
                          prefill_chunks: int) -> str:
    """The trainer's collect chunk and update burst as CUDA graphs against the same calls run eagerly,
    from one prefilled state and one generator state on deep copies: ``GRAPH_CALLS`` collect chunks of
    ``T_`` steps, then ``GRAPH_CALLS`` bursts of ``GRAPH_K`` updates. The collect outputs, the rings, the
    collect state (the policy's carry included), the stats, every weight and optimizer tensor must be
    bit-identical, and the kernels launched the same. Returns a report line."""
    import copy

    from tianshou_tpu_torch.ops.kernels import counters
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    ts = algo.init(DEV)
    bs = buffer.init(example, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    cstate = coll.reset(gen)
    for _ in range(prefill_chunks):
        coll.collect(ts, cstate, bs, gen, T_, random=True)
    sides = {}
    for side in ("graph", "eager"):
        s_ts, s_bs, s_cs = copy.deepcopy((ts, bs, cstate))
        s_gen = torch.Generator(device=DEV)
        s_gen.set_state(gen.get_state())
        trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(
            batch_size=batch, collection_step_num_env_steps=T_, verbose=False)) if side == "graph" else None
        before = counters.snapshot()
        outs, stats = [], []
        for _ in range(GRAPH_CALLS):
            out = (coll.collect(s_ts, s_cs, s_bs, s_gen, T_)[2] if trainer is None
                   else trainer.collect_chunk(s_ts, s_cs, s_bs, s_gen, T_))
            outs.append(out.map(torch.clone))
        for _ in range(GRAPH_CALLS):
            if trainer is None:
                st = [algo.update(s_ts, buffer, s_bs, s_gen, batch)[2] for _ in range(GRAPH_K)]
                st = {k: torch.stack([x[k] for x in st]) for k in st[0].keys()}
            else:
                st = trainer.update_burst(s_ts, s_bs, s_gen, GRAPH_K)
            stats.append({k: v.clone() for k, v in st.items()})
        torch.cuda.synchronize()
        after = counters.snapshot()
        sides[side] = dict(ts=s_ts, bs=s_bs, cstate=s_cs, outs=outs, stats=stats, trainer=trainer,
                           launches={k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)})
    g, e = sides["graph"], sides["eager"]
    replays = {x.name.split()[0]: x.replays for x in g["trainer"].graph_pool.graphs}
    if replays != {"collect_chunk": GRAPH_CALLS - 1, "update_burst": GRAPH_CALLS - 1}:
        raise AssertionError(f"{name} graph check: replays {replays}")
    pairs = [(x, y) for call in range(GRAPH_CALLS) for x, y in zip(_leaves(g["outs"][call]), _leaves(e["outs"][call]))]
    pairs += [(g["stats"][c][k], e["stats"][c][k]) for c in range(GRAPH_CALLS) for k in e["stats"][c]]
    pairs += list(zip(_leaves(g["cstate"]), _leaves(e["cstate"])))
    pairs += [(g["bs"].cursor, e["bs"].cursor), (g["bs"].size, e["bs"].size), *zip(_leaves(g["bs"].data), _leaves(e["bs"].data))]
    for a, b in ((g["ts"].model, e["ts"].model), (g["ts"].target, e["ts"].target)):
        pairs += list(zip(a.state_dict().values(), b.state_dict().values()))
    pairs += list(zip(_optimizer_state(g["ts"]), _optimizer_state(e["ts"])))
    differ = sum(not torch.equal(x, y) for x, y in pairs)
    if differ or not int(g["ts"].step) == int(e["ts"].step) == GRAPH_CALLS * GRAPH_K:
        raise AssertionError(f"{name} graph check: {differ} of {len(pairs)} tensors differ from eager")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"{name} graph check: launches {g['launches']}, eager {e['launches']}")
    return (f"{name} graph check, graphs against eager: {GRAPH_CALLS} collect chunks of T={T_} (the policy's carry "
            f"under the graph) and {GRAPH_CALLS} x {GRAPH_K} updates: {len(pairs)} tensors (collect outputs and state, "
            f"rings, stats, weights, targets, optimizer state) bit-identical, max |diff| 0; launches {g['launches']} as "
            f"eager; replays {replays}")


def recurrent_dqn_pomdp_path(torch):
    """``tests/test_recurrent.py:62-92`` on the card: the graph check, then RecurrentDQN trained through the
    graphed ``OffPolicyTrainer`` to ``RQ_THRESHOLD``; exactly 2 ``gather_rows`` per update (the stacked obs
    and the n-step terminal row's stacked obs_next, rows of 8 bytes). Returns ({kernel: launches}, lines)."""
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    algo, buffer, tc, ec = build_recurrent(torch)
    example = _vector_example(torch, torch.zeros(2), torch.tensor(0))
    check = offpolicy_graph_check(torch, "recurrent_dqn_pomdp", algo, buffer, example, tc, RQ_T, RQ_BATCH, 2)
    algo, buffer, tc, ec = build_recurrent(torch)
    tests = []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    params = OffPolicyTrainerParams(
        max_epochs=RQ_EPOCHS, epoch_num_steps=RQ_EPOCH_STEPS, test_step_num_episodes=10, batch_size=RQ_BATCH,
        collection_step_num_env_steps=RQ_T, update_per_step=RQ_UPS, start_steps=RQ_PREFILL,
        stop_fn=lambda r: r >= RQ_THRESHOLD, compute_score_fn=score,
        train_fn=lambda epoch, step: {"eps_training": max(0.05, 0.3 * (1 - step / 40000))}, verbose=False)
    trainer = OffPolicyTrainer(algo, tc, ec, buffer, params)
    read = _host_launches()
    res = trainer.run(algo.init(DEV), buffer.init(example, device=DEV), torch.Generator(device=DEV).manual_seed(SEED))
    launches = read()
    if not res.best_reward >= RQ_THRESHOLD:
        raise AssertionError(f"recurrent_dqn_pomdp: best test reward {res.best_reward} after {res.epochs} epochs (by "
                             f"epoch {[round(float(s.returns.mean()), 1) for s in tests]}), below {RQ_THRESHOLD}")
    expect = {"gather_rows": 2 * res.gradient_step, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": 0}
    if launches != expect:
        raise AssertionError(f"recurrent_dqn_pomdp: launches {launches} for {res.gradient_step} updates, expected {expect}")
    t = res.timing
    train_steps = res.env_step - RQ_PREFILL
    graphs = {g.name.split()[0]: round(g.capture_s, 2) for g in trainer.graph_pool.graphs if g.capture_s is not None}
    return launches, [check, (
        f"recurrent_dqn_pomdp path: best test reward {res.best_reward:.1f} (threshold {RQ_THRESHOLD}) after {res.epochs} "
        f"epochs (test reward by epoch {[round(float(s.returns.mean()), 1) for s in tests]}); env_steps {res.env_step} "
        f"gradient_steps {res.gradient_step}; collect {t['collect']:.2f} s, update {t['update']:.2f} s ("
        f"{t['update'] / res.gradient_step * 1e3:.3f} ms per update with the captures), test {t['test']:.2f} s; train "
        f"env_steps_per_s {train_steps / (t['collect'] + t['update']):.1f}; gather_rows {launches['gather_rows']} = 2 per "
        f"update, rows of {2 * 4} B, {RQ_BATCH * RQ_STACK} rows a gather; capture s {graphs}")]


def goal_nets():
    """``tests/test_her.py:64-80``'s goal-conditioned actor and critic (128x128 MLPs) in the port."""
    import torch
    from torch import nn

    from tianshou_tpu_torch.models.mlp import MLP

    class GoalActor(nn.Module):
        def __init__(self) -> None:
            super().__init__()
            self.mlp = MLP(4, (128, 128), 2)

        def forward(self, obs):
            return torch.tanh(self.mlp(torch.cat([obs.observation, obs.desired_goal], dim=-1)))

    class GoalCritic(nn.Module):
        def __init__(self) -> None:
            super().__init__()
            self.mlp = MLP(6, (128, 128), 1)

        def forward(self, obs, act):
            return self.mlp(torch.cat([obs.observation, obs.desired_goal, act], dim=-1))[:, 0]

    return GoalActor(), GoalCritic()


def build_her(torch, n_step: int, seed: int):
    """(algo, HER buffer, example, train collector, test collector) of ``tests/test_her.py:run_goal_ddpg``."""
    from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.her import HERVectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.goal_reach import GoalReach
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.exploration.noise import GaussianNoise

    torch.manual_seed(seed)
    env = GoalReach(size=1.0, step_size=0.05, eps=0.05, max_episode_steps=60)
    actor, critic = goal_nets()
    algo = DDPG(actor=actor, critic=critic, action_space=env.action_space,
                policy_optim=AdamOptimizerFactory(lr=1e-3), critic_optim=AdamOptimizerFactory(lr=1e-3), gamma=0.98,
                tau=0.005, exploration_noise=GaussianNoise(sigma=0.3), action_scaling=False,
                n_step_return_horizon=n_step)
    buffer = HERVectorReplayBuffer(HER_BUFFER, HER_E, compute_reward_fn=env.compute_reward, horizon=60, future_k=8.0)
    goal = Batch(observation=torch.zeros(2), achieved_goal=torch.zeros(2), desired_goal=torch.zeros(2))
    example = _vector_example(torch, goal, torch.zeros(2))
    return (algo, buffer, example, DeviceCollector(VectorDeviceEnv(env, HER_E, device=DEV), algo, buffer),
            DeviceCollector(VectorDeviceEnv(env, HER_TEST_E, device=DEV), algo, None))


def her_ddpg_goal_reach_path(torch, n_step: int):
    """``tests/test_her.py:110-145`` at ``n_step`` on the card: the graph check (the relabelled update burst,
    its future-goal draws from the graph's generator, against eager), then HER-DDPG through the graphed
    ``OffPolicyTrainer`` from each of ``HER_SEEDS``; the median of their best test rewards within
    ``HER_EPOCHS`` epochs must reach ``HER_THRESHOLD`` (one seed's best reward spreads over about 2 in both
    packages: PERF.md, section 6). No kernel. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    name = f"her_ddpg_goal_reach_n{n_step}"
    algo, buffer, example, tc, ec = build_her(torch, n_step, SEED)
    lines = [offpolicy_graph_check(torch, name, algo, buffer, example, tc, HER_T, HER_BATCH, 8)]
    read = _host_launches()
    bests = []
    for seed in HER_SEEDS:
        algo, buffer, example, tc, ec = build_her(torch, n_step, seed)
        tests = []

        def score(stats, tests=tests) -> float:
            tests.append(stats)
            return float(stats.returns.mean())

        params = OffPolicyTrainerParams(
            max_epochs=HER_EPOCHS, epoch_num_steps=HER_EPOCH_STEPS, test_step_num_episodes=20, batch_size=HER_BATCH,
            collection_step_num_env_steps=HER_T, update_per_step=HER_UPS, start_steps=HER_PREFILL, start_random=False,
            stop_fn=lambda r: r >= -12, compute_score_fn=score, verbose=False)
        trainer = OffPolicyTrainer(algo, tc, ec, buffer, params)
        res = trainer.run(algo.init(DEV), buffer.init(example, device=DEV), torch.Generator(device=DEV).manual_seed(seed))
        bests.append(res.best_reward)
        t = res.timing
        lines.append(
            f"{name} path, seed {seed}: best test reward {res.best_reward:.2f} after {res.epochs} epochs (test reward by "
            f"epoch {[round(float(s.returns.mean()), 2) for s in tests]}); env_steps {res.env_step} gradient_steps "
            f"{res.gradient_step}; collect {t['collect']:.2f} s, update {t['update']:.2f} s "
            f"({t['update'] / res.gradient_step * 1e3:.3f} ms per update with the captures), test {t['test']:.2f} s; "
            f"train env_steps_per_s {(res.env_step - HER_PREFILL) / (t['collect'] + t['update']):.1f}")
    launches = read()
    median = statistics.median(bests)
    if not median >= HER_THRESHOLD:
        raise AssertionError(f"{name}: the median best test reward of seeds {HER_SEEDS} is {median} ({bests}), below "
                             f"{HER_THRESHOLD}")
    if any(launches.values()):
        raise AssertionError(f"{name}: kernel launches {launches}, expected none")
    lines.append(f"{name} path: median best test reward {median:.2f} of seeds {HER_SEEDS} ({[round(b, 2) for b in bests]}; "
                 f"threshold {HER_THRESHOLD}); no kernel")
    return launches, lines


CACHED_SCRIPTS = (  # tests/test_cached_buffer.py: (buffer kwargs, adds of (obs per env, done per env))
    (dict(main_size=16, num_envs=1, max_episode_len=4), [([0.0], [0]), ([1.0], [0]), ([2.0], [0]), ([3.0], [1])]),
    (dict(main_size=16, num_envs=2, max_episode_len=8), [([0.0, 100.0], [0, 0]), ([1.0, 101.0], [1, 0])]),
    (dict(main_size=16, num_envs=2, max_episode_len=8), [([i, 10.0 + i], [i == 2] * 2) for i in range(3)]),
    (dict(main_size=4, num_envs=1, max_episode_len=4), [([b + j], [j == 1]) for b in (0.0, 10.0, 20.0) for j in (0, 1)]),
    (dict(main_size=16, num_envs=3, max_episode_len=8), [([1.0, 2.0, 3.0], [0, 1, 0])]),
    (dict(main_size=8, num_envs=1, max_episode_len=4), [([5.0], [0]), ([6.0], [1])]),
    (dict(main_size=8, num_envs=2, max_episode_len=4, stack_num=2),
     [([0.0, 50.0], [0, 0]), ([1.0, 51.0], [0, 1]), ([2.0, 60.0], [1, 0])]),
    (dict(main_size=16, num_envs=2, max_episode_len=4, stack_num=3),
     [([s, 100.0 + s], [s % 3 == 2, s % 4 == 3]) for s in range(12)]),
)


def cached_buffer_phase(torch):
    """The episodes of ``tests/test_cached_buffer.py`` (and 40 adds of random episodes over 3 envs) replayed
    into a ``CachedReplayBuffer`` on the card and on the CPU: the main ring and the caches (data,
    cursors, sizes, newest rows) and the stacked gets of every main row (``gather_rows`` on the card)
    bit-identical. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.cached import CachedReplayBuffer

    rng = np.random.default_rng(SEED)
    scripts = list(CACHED_SCRIPTS)
    length, adds = np.zeros(3, int), []
    for _ in range(40):
        done = (rng.random(3) < 0.3) | (length == 4)
        adds.append((rng.standard_normal(3).tolist(), done.tolist()))
        length = np.where(done, 0, length + 1)
    scripts.append((dict(main_size=24, num_envs=3, max_episode_len=5, stack_num=2), adds))
    ex = Batch(obs=torch.tensor(0.0), act=torch.tensor(0), rew=torch.tensor(0.0), terminated=torch.tensor(False),
               truncated=torch.tensor(False), obs_next=torch.tensor(0.0))
    read = _host_launches()
    tensors, launches = 0, dict.fromkeys(read(), 0)
    for kw, script in scripts:
        states = {}
        for side, dev in enumerate(("cpu", DEV)):
            before = read()
            buf = CachedReplayBuffer(**kw)
            state = buf.init(ex, device=dev)
            for obs, done in script:
                o = torch.tensor(obs, dtype=torch.float32, device=dev)
                buf.add(state, Batch(obs=o, act=torch.zeros(len(obs), dtype=torch.int64, device=dev), rew=o * 0.1,
                                     terminated=torch.tensor(done, dtype=torch.bool, device=dev),
                                     truncated=torch.zeros(len(obs), dtype=torch.bool, device=dev), obs_next=o + 1))
            got = buf.get(state, torch.arange(buf.main.capacity, device=dev))
            states[side] = [*_leaves(state.main.data), *_leaves(state.cache.data), state.main.cursor, state.main.size,
                            state.main.last_idx, state.cache.cursor, state.cache.size, *_leaves(got)]
            if side:  # the card's adds and gets only
                launches = {k: n + read()[k] - before[k] for k, n in launches.items()}
        pairs = list(zip(states[0], states[1]))
        if not all(torch.equal(a, b.cpu()) for a, b in pairs):
            raise AssertionError(f"cached buffer {kw}: the card's rings or stacked gets differ from the CPU's")
        tensors += len(pairs)
    stacked = sum(kw.get("stack_num", 1) > 1 for kw, _ in scripts)
    if launches != {"gather_rows": 2 * stacked, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": 0}:
        raise AssertionError(f"cached buffer: launches {launches}, expected 2 gather_rows for each of {stacked} stacked gets")
    return launches, [f"cached buffer: {len(scripts)} scripts ({sum(len(s) for _, s in scripts)} adds) on the card and "
                      f"on the CPU: {tensors} tensors (main ring, caches, stacked gets) bit-identical; gather_rows "
                      f"{launches['gather_rows']} (obs and obs_next of {stacked} stacked gets)"]


class FiniteDataset:
    """``tests/test_env_finite.py:20``: 100 samples; sample i lasts (3 i mod 5) + 1 env steps."""

    def __init__(self, length: int) -> None:
        self.episodes = [3 * i % 5 + 1 for i in range(length)]

    def __len__(self) -> int:
        return len(self.episodes)


class FiniteStreamEnv:
    """One shard of the dataset; ``reset`` gives ``(None, {})`` once the shard is exhausted."""

    def __init__(self, dataset: FiniteDataset, replicas: int, rank: int) -> None:
        self.dataset = dataset
        self.indices = list(range(rank, len(dataset), replicas))
        self.iterator = None

    def reset(self, seed=None, **kw):
        if self.iterator is None:
            self.iterator = iter(self.indices)
        try:
            self.sample = next(self.iterator)
        except StopIteration:
            self.iterator = None
            return None, {}
        self.step_count, self.current = self.dataset.episodes[self.sample], 0
        return np.float32(self.sample), {}

    def step(self, action):
        self.current += 1
        return np.float32(0), 1.0, self.current >= self.step_count, False, {"sample": self.sample}

    def close(self) -> None:
        pass


class _Counter:
    """The finite venv's tracker: env steps and finished samples."""

    def __init__(self) -> None:
        self.steps, self.finished = 0, []

    def log(self, obs, rew, terminated, truncated, info) -> None:
        self.steps += 1
        if terminated or truncated:
            self.finished.append(info["sample"])


def finite_env_phase(torch) -> list[str]:
    """``tests/test_env_finite.py``'s sharded dataset through ``HostCollector`` (action 1 for every env, on
    the card) over ``FiniteSubprocVectorEnv``, three epochs, against the same collect on the CPU over
    ``FiniteDummyVectorEnv``: every sample finishes once per epoch, ``StopIteration`` ends each epoch,
    the step counts are the CPU's."""
    from tianshou_tpu_torch.algorithm.base import ActOut
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.finite import FiniteDummyVectorEnv, FiniteSubprocVectorEnv

    class ActOne:
        def forward(self, ts, obs, generator=None, state=None, deterministic=False):
            return ActOut(act=torch.ones(obs.shape[0], dtype=torch.int64, device=obs.device), state=state, info=Batch())

        def exploration_noise(self, ts, act, obs, generator, training=True):
            return act

        def map_action(self, act):
            return act

    counts = []  # steps per epoch: the CPU's, the card's
    for dev, cls, kw in (("cpu", FiniteDummyVectorEnv, {}), (DEV, FiniteSubprocVectorEnv, {"recv_timeout": WAIT_S})):
        dataset = FiniteDataset(100)
        venv = cls([(lambda r=r: FiniteStreamEnv(dataset, 5, r)) for r in range(5)], **kw)
        try:
            coll = HostCollector(venv, ActOne(), None, device=dev)
            coll.reset()
            counts.append([])
            for _ in range(3):
                venv.tracker = _Counter()
                try:
                    coll.collect(None, torch.Generator(device=dev), n_step=10**9)
                except StopIteration:
                    pass
                else:
                    raise AssertionError("finite envs: a collect ended without StopIteration")
                if sorted(venv.tracker.finished) != list(range(100)):
                    raise AssertionError(f"finite envs on {dev}: {len(venv.tracker.finished)} samples finished")
                counts[-1].append(venv.tracker.steps)
        finally:
            venv.close()
    if counts[0] != counts[1]:
        raise AssertionError(f"finite envs: steps per epoch {counts[1]} on the card, {counts[0]} on the CPU")
    return [f"finite envs: 3 epochs of the 100-sample dataset over FiniteSubprocVectorEnv through HostCollector on the "
            f"card: every sample once per epoch, StopIteration at each end, {counts[1]} env steps per epoch as on the CPU"]


# ---------------------------------------------------------------------------
# the offline trainer and the offline, imitation and model-based family
# ---------------------------------------------------------------------------
# the offline pixel paths (examples/offline/atari_{bcq,cql,crr}.py's defaults at bench.py's widths): the DQN pipeline's
# collector fills the whole ring once (SLOTS steps of E envs, no updates) at eps OFF_FILL_EPS; each algorithm then
# trains from a copy of that ring for one epoch of OFF_UPDATES updates (cut from 100 epochs of 10,000) in bursts of
# ``OfflineTrainer.BURST`` (100), one CUDA graph replayed (PERF.md says why 100), with the pixel
# paths' test phase after it
OFFLINE_KINDS = ("bcq", "cql", "crr")
OFF_FILL_EPS, OFF_UPDATES = 0.2, 1_000
# gather_rows per update, counted from the fields each JAX update reads: every update samples obs and obs_next (one
# [B * 4]-row gather each); at n = 1 discrete BCQ and CQL reuse the sampled obs_next as the n-step terminal row
# (algorithm/base.py:_nstep_terminal), and CRR reads the sampled row itself
OFFLINE_GATHERS = {"bcq": 2, "cql": 2, "crr": 2}
# the classic offline paths (tests/test_offline.py:67-161): the datasets of tests/conftest.py:66-149 (DQN trained on
# CartPole to 195, then 2,000 steps of 10 envs at eps 0.2; SAC trained on Pendulum to -250, then 2,500 steps of 8
# envs), up to 8 epochs of 500 updates of batch 64 (CQL: 10 of batch 128), 10 test episodes; thresholds 150 / -800
OFF_CLASSIC = {"offline_cartpole": ("bc", "discrete_bcq", "discrete_cql", "discrete_crr"),
               "offline_pendulum": ("bc", "td3_bc", "bcq", "cql")}
OFF_THRESHOLD = {"offline_cartpole": 150.0, "offline_pendulum": -800.0}
# TD3+BC and CQL reach -800 on Pendulum from some seeds and not others in both packages: the JAX package's own TD3+BC
# from 4 of 8 seeds on its dataset from key 1 and on this path's dataset, its CQL from 4 of 20 on its test's dataset
# (PERF.md, the offline findings; scripts/seed_spread{,_jax}.py). Each trains from the seeds below, stopping at -800
# as its test does, and the median of their best rewards must reach a gate that every JAX seed measured reached
# (TD3+BC's worst -972.6 of 24 over three datasets, CQL's -1,103.3 of 28 over two): (path, algorithm) -> (seeds, gate)
OFF_SEEDS = {("offline_pendulum", "td3_bc"): ((0, 1, 2), -1000.0), ("offline_pendulum", "cql"): ((0, 1, 2), -1150.0)}
# the model-based paths (tests/test_modelbased.py): name -> threshold
MB_THRESHOLD = {"gail_pendulum": -1100.0, "icm_dqn_cartpole": 195.0, "icm_ppo_cartpole": 195.0, "psrl_nchain": 340.0}


def build_offline(torch, kind: str, action_space):
    """The pixel path's algorithm of ``kind`` with its example script's nets and defaults: ``DiscreteBCQ`` over
    two ``DQNet(6)`` (lr 6.25e-5, n 1, target sync 8,000, threshold 0.3, logits penalty 0.01), ``DiscreteCQL`` over
    ``QRDQNet(6, 200)`` (lr 1e-4, n 1, target sync 500, min_q_weight 10), ``DiscreteCRR`` over two ``DQNet(6)``
    (lr 1e-4, exp mode, ratio bound 20, beta 1, min_q_weight 10, target sync 500); gamma 0.99."""
    from tianshou_tpu_torch.algorithm.imitation.discrete_bcq import DiscreteBCQ
    from tianshou_tpu_torch.algorithm.imitation.discrete_cql import DiscreteCQL
    from tianshou_tpu_torch.algorithm.imitation.discrete_crr import DiscreteCRR
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.atari import DQNet, QRDQNet

    torch.manual_seed(SEED)
    if kind == "bcq":
        return DiscreteBCQ(model=DQNet(6), imitator=DQNet(6), action_space=action_space,
                           optim=AdamOptimizerFactory(lr=6.25e-5), gamma=0.99, n_step_return_horizon=1,
                           target_update_freq=8000, unlikely_action_threshold=0.3, imitation_logits_penalty=0.01)
    if kind == "cql":
        return DiscreteCQL(model=QRDQNet(6, 200), action_space=action_space, num_quantiles=200,
                           optim=AdamOptimizerFactory(lr=1e-4), gamma=0.99, n_step_return_horizon=1,
                           target_update_freq=500, min_q_weight=10.0)
    return DiscreteCRR(actor=DQNet(6), critic=DQNet(6), action_space=action_space, optim=AdamOptimizerFactory(lr=1e-4),
                       gamma=0.99, policy_improvement_mode="exp", ratio_upper_bound=20.0, beta=1.0, min_q_weight=10.0,
                       target_update_freq=500)


def fill_offline_ring(torch):
    """The dataset of the offline pixel paths: ``bench.py``'s ring (E rings of SLOTS uint8 84x84 frames, stack 4,
    newest frame only) filled once by the DQN pipeline's collector at eps ``OFF_FILL_EPS`` from its seeded,
    untrained weights: SLOTS steps of every env, as collect chunks of T steps (the trainer's program, a CUDA
    graph), no updates. Returns (buffer, buffer state, action space, report line)."""
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    algo, ts, buffer, bs, coll = build_pipeline(torch, "dqn")
    ts.hparams["eps_training"].fill_(OFF_FILL_EPS)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(collection_step_num_env_steps=T,
                                                                              verbose=False))
    cstate = coll.reset(gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    episodes = 0
    for _ in range(SLOTS // T):
        episodes += int(trainer.collect_chunk(ts, cstate, bs, gen, T).done.sum())
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if not bool((bs.size == SLOTS).all()) or bs.data.obs.dtype != torch.uint8:
        raise AssertionError(f"offline ring: sizes {bs.size.min().item()}..{bs.size.max().item()}, expected {SLOTS}")
    line = (f"offline ring: {E} x {SLOTS} rows of uint8 {tuple(bs.data.obs.shape[2:])} frames (obs and obs_next, "
            f"{2 * bs.data.obs.numel() / 1e9:.3f} GB) filled by the DQN pipeline's collector from its untrained seeded "
            f"weights at eps {OFF_FILL_EPS} in {fill_s:.2f} s ({SLOTS // T} collect chunks of T={T}, the first eager "
            f"and the second captured; {episodes} episodes ended), no updates")
    del trainer, ts, coll
    return buffer, bs, algo.action_space, line


def offline_graph_check(torch, name: str, algo, buffer, bs, batch: int) -> str:
    """``OfflineTrainer``'s update burst as a CUDA graph against ``algo.update`` run eagerly, on deep copies of one
    fresh train state from one generator state: ``GRAPH_CALLS`` bursts of ``GRAPH_K`` updates (the first the
    program's eager warm-up, the second its capture). The sampled indices (logged on the device), the stats,
    every weight, target and optimizer tensor and the step must be bit-identical (cuDNN held to deterministic
    algorithms), and the kernels launched the same. A multi-agent train state (a dict) is compared agent by agent.
    The buffer is only read. Returns a report line."""
    import copy

    from tianshou_tpu_torch.ops.kernels import counters
    from tianshou_tpu_torch.trainer.trainer import OfflineTrainer, OfflineTrainerParams, _stack_stats

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ts = algo.init(DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    sample_indices = buffer.sample_indices
    sides = {}
    try:
        for side in ("graph", "eager"):
            s_ts = copy.deepcopy(ts)
            s_gen = torch.Generator(device=DEV)
            s_gen.set_state(gen.get_state())
            buffer.sample_indices, log = _logged(torch, sample_indices, (GRAPH_CALLS * GRAPH_K, batch), DEV)
            trainer = OfflineTrainer(algo, buffer, None, OfflineTrainerParams(batch_size=batch, verbose=False)) \
                if side == "graph" else None
            before = counters.snapshot()
            stats = []
            for _ in range(GRAPH_CALLS):
                if trainer is None:
                    st = _stack_stats([algo.update(s_ts, buffer, bs, s_gen, batch)[2] for _ in range(GRAPH_K)])
                else:
                    st = trainer.update_burst(s_ts, bs, s_gen, GRAPH_K)
                stats.append([x.clone() for x in _leaves(st)])
            torch.cuda.synchronize()
            after = counters.snapshot()
            sides[side] = dict(ts=s_ts, stats=stats, idx=log, trainer=trainer,
                               launches={k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)})
    finally:
        buffer.sample_indices = sample_indices
        torch.backends.cudnn.deterministic = deterministic
    g, e = sides["graph"], sides["eager"]
    replays = {x.name.split()[0]: x.replays for x in g["trainer"].graph_pool.graphs}
    if replays != {"update_burst": GRAPH_CALLS - 1} or int((e["idx"] < 0).sum()) != 0:
        raise AssertionError(f"{name} graph check: replays {replays}, eager batches {int(e['idx'][:, 0].ge(0).sum())}")
    pairs = [(g["idx"], e["idx"])]
    pairs += [(x, y) for c in range(GRAPH_CALLS) for x, y in zip(g["stats"][c], e["stats"][c])]
    agents = list(zip(*(list(side["ts"].values()) if isinstance(side["ts"], dict) else [side["ts"]] for side in (g, e))))
    for gts, ets in agents:
        for a, b in ((gts.model, ets.model), (gts.target, ets.target)):
            if a is not None:
                pairs += list(zip(a.state_dict().values(), b.state_dict().values()))
        pairs += list(zip(_optimizer_state(gts), _optimizer_state(ets)))
    differ = sum(not torch.equal(x, y) for x, y in pairs)
    if differ or not all(int(gts.step) == int(ets.step) == GRAPH_CALLS * GRAPH_K for gts, ets in agents):
        raise AssertionError(f"{name} graph check: {differ} of {len(pairs)} tensors differ from eager")
    if torch.equal(g["idx"][GRAPH_K:2 * GRAPH_K], g["idx"][2 * GRAPH_K:]):
        raise AssertionError(f"{name} graph check: two replays drew the same indices")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"{name} graph check: launches {g['launches']}, eager {e['launches']}")
    return (f"{name} graph check, graphs against eager: {GRAPH_CALLS} x {GRAPH_K} updates of batch {batch}: "
            f"{len(pairs)} tensors (sampled indices, stats, weights, targets, optimizer state) bit-identical, max |diff| "
            f"0; launches {g['launches']} as eager; replays {replays}")


def _timed_test(torch, trainer) -> dict:
    """Wrap the trainer's test phase to time it (synchronized); returns the dict the times add up in."""
    spent = {"test": 0.0}
    real = trainer._test

    def timed(ts, generator):
        t0 = time.perf_counter()
        stats = real(ts, generator)
        torch.cuda.synchronize()
        spent["test"] += time.perf_counter() - t0
        return stats

    trainer._test = timed
    return spent


def offline_pixel_path(torch, kind: str, buffer, ring, action_space):
    """``examples/offline/atari_{kind}.py``'s defaults at bench.py's widths: the graph check, then one epoch of
    ``OFF_UPDATES`` updates of batch 32 through ``OfflineTrainer`` from a copy of the offline ring (bursts of
    ``OfflineTrainer.BURST``, one CUDA graph), then the test phase (10 episodes on ``TEST_E`` envs). Launch counters
    are zeroed just before the run and read just after it: ``gather_rows`` must run exactly ``OFFLINE_GATHERS[kind]``
    times per update, and no other kernel. Then one replayed burst is timed and traced (``_trace_burst``). Returns
    ({kernel: launches}, report lines)."""
    import copy

    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import OfflineTrainer, OfflineTrainerParams

    name = f"offline_{kind}_pixels"
    bs = copy.deepcopy(ring)  # every algorithm trains from its own copy of the one ring
    algo = build_offline(torch, kind, action_space)
    lines = [offline_graph_check(torch, name, algo, buffer, bs, BATCH)]
    ts = algo.init(DEV)
    init = [p.detach().clone() for p in ts.model.parameters()]
    tests = []

    def score(stats) -> float:
        tests.append(stats)
        return float(stats.returns.mean())

    trainer = OfflineTrainer(algo, buffer, make_test_collector(algo), OfflineTrainerParams(
        max_epochs=1, update_step_num_gradient_steps_per_epoch=OFF_UPDATES, batch_size=BATCH,
        test_step_num_episodes=TEST_EPISODES, compute_score_fn=score, verbose=False))
    spent = _timed_test(torch, trainer)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.run(ts, bs, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(gather, sumtree, physics_fused)
    expect = {"gather_rows": OFFLINE_GATHERS[kind] * OFF_UPDATES, "prefix_sum_idx": 0, "tree_update": 0,
              "physics_fused": 0}
    if launches != expect:
        raise AssertionError(f"{name} path: kernel launches {launches} for {OFF_UPDATES} updates, expected {expect}")
    if res.gradient_step != OFF_UPDATES or int(ts.step) != OFF_UPDATES or res.env_step != 0 or res.timing:
        raise AssertionError(f"{name} path: gradient_step {res.gradient_step}, step {int(ts.step)}, env_step "
                             f"{res.env_step}, timing {res.timing}")
    burst = next(g for g in trainer.graph_pool.graphs if g.name.startswith("update_burst"))
    if burst.replays != OFF_UPDATES // trainer.BURST - 1 or len(trainer.graph_pool.graphs) != 2:
        raise AssertionError(f"{name} path: {burst.replays} burst replays, programs "
                             f"{[g.name for g in trainer.graph_pool.graphs]}")
    _check_tests(f"{name} path", tests, 1)
    loss = res.last_chunk_stats.loss
    if loss.shape != (OFF_UPDATES,) or not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"{name} path: losses of shape {tuple(loss.shape)}, finite {bool(torch.isfinite(loss).all())}")
    if not all(bool(torch.isfinite(p).all()) for p in ts.model.parameters()) or \
            all(torch.equal(a, b) for a, b in zip(init, ts.model.parameters())):
        raise AssertionError(f"{name} path: parameters non-finite or unchanged after training")
    update_s = wall - spent["test"]
    lines += [
        f"{name} path: {type(algo).__name__} from a copy of the offline ring (E={E}, {SLOTS} slots, stack 4, batch "
        f"{BATCH}); one epoch of {OFF_UPDATES} updates in bursts of {trainer.BURST} ({burst.replays} replays of one "
        f"graph, capture {burst.capture_s:.2f} s), then {TEST_EPISODES} test episodes; gather_rows {launches['gather_rows']} "
        f"({launches['gather_rows'] / OFF_UPDATES:g} per update, as counted from the fields)",
        f"{name} path: epoch wall {wall:.3f} s: updates {update_s:.3f} s ({update_s / OFF_UPDATES * 1e3:.3f} ms per "
        f"update, the eager warm-up burst and the capture included), test phase {spent['test']:.3f} s; test reward "
        f"{res.best_reward:.3f} (length mean {tests[0].lens.mean():.1f}); loss first/last "
        f"{float(loss[0]):.5f}/{float(loss[-1]):.5f}; test chunk capture "
        f"{next(g for g in trainer.graph_pool.graphs if g.name.startswith('test_chunk')).capture_s:.2f} s; graph pool "
        f"{trainer.graph_pool.memory_bytes() / 2**20:.1f} MiB",
        f"{name} path: " + _trace_burst(torch, trainer, ts, bs, gen, trainer.BURST),
    ]
    del trainer, ts, bs
    torch.cuda.empty_cache()
    return launches, lines


def _classic_buffer(torch, env, size: int, num: int, device: str | None = None):
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.env.core import Discrete

    shape = env.observation_space.shape
    act = torch.tensor(0) if isinstance(env.action_space, Discrete) else torch.zeros(env.action_space.shape)
    buffer = VectorReplayBuffer(size, num)
    return buffer, buffer.init(Batch(obs=torch.zeros(shape), act=act, rew=torch.tensor(0.0),
                                     terminated=torch.tensor(False), truncated=torch.tensor(False),
                                     obs_next=torch.zeros(shape)), device=device or DEV)


def expert_dataset(torch, task: str, seed: int = SEED):
    """``tests/conftest.py:66-149`` on the card, from ``seed`` (0 there): DQN trained on CartPole to 195 (10 + 10
    envs, a 20,000-row replay, batch 64, T 10, 0.1 updates per env step, a 1,000-step prefill, eps 0.3 annealed to
    0.1) and 2,000 steps of 10 envs collected at eps 0.2 into a 20,000-row replay; or SAC trained on Pendulum to
    -250 (8 + 10 envs, 128x128 nets, the ``PEND_*`` settings) and 2,500 steps of 8 envs collected by its policy.
    Returns (env, buffer, buffer state, the trained train state, report line)."""
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.classic.pendulum import Pendulum
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.mlp import Net
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    torch.manual_seed(seed)
    if task == "cartpole":
        env, threshold, n_env, steps = CartPole(), CP_THRESHOLD, 10, 2000
        algo = DQN(model=Net((64, 64), 2, input_dim=4), action_space=env.action_space,
                   optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=3, target_update_freq=320,
                   eps_training=0.3)
        buffer, bs = _classic_buffer(torch, env, 20000, 10)
        params = OffPolicyTrainerParams(
            max_epochs=12, epoch_num_steps=5000, test_step_num_episodes=10, batch_size=64,
            collection_step_num_env_steps=10, update_per_step=0.1, start_steps=1000, stop_fn=lambda r: r >= threshold,
            train_fn=lambda ep, step: {"eps_training": max(0.1, 0.3 * (1 - step / 30000))}, verbose=False)
    else:
        env, threshold, n_env, steps = Pendulum(), PEND_THRESHOLD, PEND_E, 2500
        algo = make_offpolicy(torch, "sac", env, PEND_HID, **PEND_ALGOS["sac"])
        buffer, bs = _classic_buffer(torch, env, PEND_BUFFER, PEND_E)
        params = OffPolicyTrainerParams(
            max_epochs=PEND_EPOCHS, epoch_num_steps=PEND_EPOCH_STEPS, test_step_num_episodes=10, batch_size=PEND_BATCH,
            collection_step_num_env_steps=PEND_T, update_per_step=PEND_UTD, start_steps=PEND_PREFILL,
            start_random=False, stop_fn=lambda r: r >= threshold, verbose=False)
    trainer = OffPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, n_env, device=DEV), algo, buffer),
                               DeviceCollector(VectorDeviceEnv(env, 10, device=DEV), algo, None), buffer, params)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    res = trainer.run(algo.init(DEV), bs, gen)
    if not res.best_reward >= threshold:
        raise AssertionError(f"{task} expert: best test reward {res.best_reward} after {res.epochs} epochs")
    data, ds = _classic_buffer(torch, env, 20000, n_env)
    ts = res.train_state
    if task == "cartpole":
        ts.hparams["eps_training"].fill_(0.2)
    coll = DeviceCollector(VectorDeviceEnv(env, n_env, device=DEV), algo, data)
    t0 = time.perf_counter()
    coll.collect(ts, coll.reset(gen), ds, gen, steps, training=True)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    if int(ds.size.sum()) != min(20000, n_env * steps):
        raise AssertionError(f"{task} expert: {int(ds.size.sum())} rows gathered")
    return env, data, ds, ts, (
        f"{task} expert dataset: {type(algo).__name__} reached {res.best_reward:.1f} after {res.epochs} epochs "
        f"({res.train_time:.2f} s), then {steps} steps of {n_env} envs collected eagerly in {gather_s:.2f} s "
        f"({int(ds.size.sum())} rows{', eps 0.2' if task == 'cartpole' else ''}; reward per row "
        f"{float(ds.data.rew.mean()):.4f})")


def build_offline_classic(torch, name: str, env):
    """The algorithm of ``tests/test_offline.py`` called ``name`` on ``env``: (algo, epochs, batch)."""
    from tianshou_tpu_torch.algorithm.imitation.bc import ImitationLearning
    from tianshou_tpu_torch.algorithm.imitation.bcq import BCQ
    from tianshou_tpu_torch.algorithm.imitation.cql import CQL
    from tianshou_tpu_torch.algorithm.imitation.discrete_bcq import DiscreteBCQ
    from tianshou_tpu_torch.algorithm.imitation.discrete_cql import DiscreteCQL
    from tianshou_tpu_torch.algorithm.imitation.discrete_crr import DiscreteCRR
    from tianshou_tpu_torch.algorithm.imitation.td3_bc import TD3BC
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory as Adam
    from tianshou_tpu_torch.env.core import Discrete
    from tianshou_tpu_torch.models.continuous import (
        VAE,
        ContinuousActorDeterministic,
        ContinuousActorProbabilistic,
        ContinuousCritic,
        Perturbation,
    )
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
    from tianshou_tpu_torch.models.mlp import Net

    torch.manual_seed(SEED)
    space = env.action_space
    if isinstance(space, Discrete):
        q = dict(gamma=0.97, n_step_return_horizon=3, target_update_freq=320)
        algo = {
            "bc": lambda: ImitationLearning(model=DiscreteActor((64, 64), 2, input_dim=4), action_space=space,
                                            optim=Adam(lr=1e-3)),
            "discrete_bcq": lambda: DiscreteBCQ(model=Net((64, 64), 2, input_dim=4),
                                                imitator=DiscreteActor((64, 64), 2, input_dim=4), action_space=space,
                                                optim=Adam(lr=3e-4), unlikely_action_threshold=0.6, **q),
            "discrete_cql": lambda: DiscreteCQL(model=Net((64, 64), 2, num_atoms=64, input_dim=4), action_space=space,
                                                num_quantiles=64, optim=Adam(lr=3e-4), min_q_weight=10.0, **q),
            "discrete_crr": lambda: DiscreteCRR(actor=DiscreteActor((64, 64), 2, input_dim=4),
                                                critic=DiscreteCritic((64, 64), last_size=2, input_dim=4),
                                                action_space=space, optim=Adam(lr=3e-4), gamma=0.97,
                                                target_update_freq=320),
        }[name]()
        return algo, 8, 64
    hid, opts = (128, 128), dict(policy_optim=Adam(lr=3e-4), critic_optim=Adam(lr=3e-4))
    algo = {
        "bc": lambda: ImitationLearning(model=ContinuousActorDeterministic((64, 64), 1, max_action=2.0, input_dim=3),
                                        action_space=space, optim=Adam(lr=1e-3), action_bound_method=None),
        "td3_bc": lambda: TD3BC(actor=ContinuousActorDeterministic(hid, 1, input_dim=3),
                                critic=ContinuousCritic(hid, input_dim=3, action_dim=1), action_space=space, gamma=0.99,
                                tau=0.005, alpha=2.5, **opts),
        "bcq": lambda: BCQ(actor_perturbation=Perturbation((64, 64), 1, max_action=1.0, phi=0.05, input_dim=3),
                           critic=ContinuousCritic((64, 64), input_dim=3, action_dim=1),
                           vae=VAE((64,), (64,), 1, 2, max_action=1.0, input_dim=3), action_space=space, gamma=0.99,
                           tau=0.005, forward_sampled_times=20, num_sampled_action=10),
        "cql": lambda: CQL(actor=ContinuousActorProbabilistic(hid, 1, conditioned_sigma=True, input_dim=3),
                           critic=ContinuousCritic(hid, input_dim=3, action_dim=1), action_space=space, cql_weight=1.0,
                           with_lagrange=True, num_repeat_actions=10, **opts),
    }[name]()
    return algo, (10 if name == "cql" else 8), (128 if name == "cql" else 64)


def run_offline_classic(torch, algo, env, buffer, bs, epochs: int, batch: int, seed: int,
                        device: str | None = None, stop: float | None = None):
    """One run of ``tests/test_offline.py:run_offline`` from ``seed``: torch seeded just before the train state is
    made (so a seed's initial weights do not depend on what ran before), up to ``epochs`` of 500 updates of
    ``batch`` through ``OfflineTrainer`` with the generator seeded alike, 10 test episodes on 10 envs after each,
    stopping once the test reward reaches ``stop``, on ``device`` (``DEV`` by default). Returns (result, test reward
    by epoch, test phases' seconds, nan on the CPU)."""
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.trainer.trainer import OfflineTrainer, OfflineTrainerParams

    device = device or DEV
    tests = []

    def score(stats) -> float:
        tests.append(float(stats.returns.mean()))
        return tests[-1]

    trainer = OfflineTrainer(algo, buffer, DeviceCollector(VectorDeviceEnv(env, 10, device=device), algo, None),
                             OfflineTrainerParams(max_epochs=epochs, update_step_num_gradient_steps_per_epoch=500,
                                                  batch_size=batch, test_step_num_episodes=10,
                                                  stop_fn=None if stop is None else (lambda r: r >= stop),
                                                  compute_score_fn=score, verbose=False))
    spent = _timed_test(torch, trainer) if torch.device(device).type == "cuda" else {"test": float("nan")}
    torch.manual_seed(seed)
    ts = algo.init(device)
    res = trainer.run(ts, bs, torch.Generator(device=device).manual_seed(seed))
    return res, tests, spent["test"]


def offline_classic_path(torch, path: str, data) -> tuple[dict, list[str]]:
    """Each algorithm of ``OFF_CLASSIC[path]`` on the phase's one expert dataset, as ``tests/test_offline.py:run_offline``
    trains it: its update graph held bit-identical to eager once (``offline_graph_check``), then up to its epochs
    of 500 updates through ``OfflineTrainer`` (bursts of 100: five graph replays an epoch), 10 test episodes on 10
    envs (``run_offline_classic``), from seed ``SEED``, stopping at ``OFF_THRESHOLD[path]`` and raising below it;
    an algorithm of ``OFF_SEEDS`` trains once from each of its seeds, stopping at that threshold too, and the
    median of their best rewards must reach its gate. No kernel (the rows are not frame-stacked). Returns
    ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree

    env, buffer, bs = data
    lines, total = [], {}
    for name in OFF_CLASSIC[path]:
        algo, epochs, batch = build_offline_classic(torch, name, env)
        lines.append(offline_graph_check(torch, f"{path} {name}", algo, buffer, bs, batch))
        seeds, gate = OFF_SEEDS.get((path, name), ((SEED,), OFF_THRESHOLD[path]))
        bests, runs = [], []
        for seed in seeds:
            for module in (gather, sumtree, physics_fused):
                module.reset_launch_count()
            res, tests, test_s = run_offline_classic(torch, algo, env, buffer, bs, epochs, batch, seed,
                                                     stop=OFF_THRESHOLD[path])
            launches = _launches(gather, sumtree, physics_fused)
            if any(launches.values()) or res.gradient_step != 500 * res.epochs or \
                    int(res.train_state.step) != res.gradient_step or not np.isfinite(res.best_reward):
                raise AssertionError(f"{path} {name} seed {seed}: launches {launches}, gradient_step "
                                     f"{res.gradient_step}, best reward {res.best_reward}")
            total = {k: total.get(k, 0) + n for k, n in launches.items()}
            bests.append(res.best_reward)
            upd = res.train_time - test_s
            runs.append(f"after {res.epochs} epochs (test reward by epoch "
                        f"{[round(x, 1) for x in tests]}); {res.gradient_step} updates of batch {batch} in {upd:.2f} s "
                        f"({upd / res.gradient_step * 1e3:.3f} ms per update, captures included), test phases "
                        f"{test_s:.2f} s")
        best = statistics.median(bests)
        if not best >= gate:
            raise AssertionError(f"{path} {name}: best test reward {bests} from seeds {seeds}, median {best}, below "
                                 f"{gate}")
        if len(seeds) == 1:
            lines.append(f"{path} {name}: best test reward {best:.1f} (threshold {gate}) {runs[0]}")
        else:
            hits = sum(b >= OFF_THRESHOLD[path] for b in bests)
            lines.append(f"{path} {name}: median best test reward {best:.1f} of seeds {seeds} (gate {gate}, OFF_SEEDS; "
                         f"{hits} of {len(seeds)} reach {OFF_THRESHOLD[path]}); "
                         + "; ".join(f"seed {sd}: {b:.1f} {r}" for sd, b, r in zip(seeds, bests, runs)))
    return total, lines


def rollout_graph_check(torch, name: str, algo, env, n_env: int, T_: int, repeat: int, batch: int,
                        step_graphs: bool = False) -> str:
    """``OnPolicyTrainer``'s ``update_rollout`` as a CUDA graph against ``algo.update_rollout`` run eagerly, on deep
    copies of one fresh train state from one generator state, over one rollout of ``T_`` steps of ``n_env`` envs
    collected eagerly: ``GRAPH_CALLS`` updates (the program's eager warm-up, its capture, a replay; with
    ``step_graphs``, the trainer's route for long rollouts, in each update the first step eager and the rest replays of
    a graph of one step). Stats, weights, optimizer state, the carried ``extra`` tensors and the step bit-identical. Returns a
    report line."""
    import copy

    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    ts = algo.init(DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    coll = DeviceCollector(VectorDeviceEnv(env, n_env, device=DEV), algo, None)
    rollout = coll.collect(ts, coll.reset(gen), None, gen, T_, keep_rollout=True)[2].rollout
    sides = {}
    for side in ("graph", "eager"):
        s_ts = copy.deepcopy(ts)
        s_gen = torch.Generator(device=DEV)
        s_gen.set_state(gen.get_state())
        trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(
            batch_size=batch, update_step_num_repetitions=repeat, verbose=False)) if side == "graph" else None
        if trainer is not None and step_graphs:
            trainer.STEP_GRAPHS_ABOVE = 0
        stats = []
        for _ in range(GRAPH_CALLS):
            st = (algo.update_rollout(s_ts, rollout, s_gen, repeat, batch)[1] if trainer is None
                  else trainer.update_rollout(s_ts, rollout, s_gen))
            stats.append(st.map(torch.clone))
        torch.cuda.synchronize()
        sides[side] = dict(ts=s_ts, stats=stats, trainer=trainer)
    g, e = sides["graph"], sides["eager"]
    pool = g["trainer"].graph_pool
    replays = {x.name.split()[0]: x.replays for x in (pool.graphs if pool is not None else [])}
    expect = {"update_rollout": GRAPH_CALLS - 1}
    if step_graphs:
        sg = g["trainer"].step_graphs
        replays.update({"steps captured": sg.captures, "steps replayed": sg.replays})
        expect = {"steps captured": 1, "steps replayed": algo.rollout_grad_steps(n_env * T_, repeat, batch) - 1}
    if replays != expect:
        raise AssertionError(f"{name} graph check: replays {replays}, expected {expect}")
    pairs = [(x, y) for c in range(GRAPH_CALLS) for x, y in zip(_leaves(g["stats"][c]), _leaves(e["stats"][c]))]
    pairs += list(zip(g["ts"].model.state_dict().values(), e["ts"].model.state_dict().values()))
    pairs += list(zip(_optimizer_state(g["ts"]), _optimizer_state(e["ts"])))
    pairs += [(g["ts"].extra[k], e["ts"].extra[k]) for k in e["ts"].extra]
    differ = sum(not torch.equal(x, y) for x, y in pairs)
    if differ or int(g["ts"].step) != int(e["ts"].step):
        raise AssertionError(f"{name} graph check: {differ} of {len(pairs)} tensors differ from eager")
    return (f"{name} graph check, {'step ' if step_graphs else ''}graphs against eager: {GRAPH_CALLS} rollout updates "
            f"({n_env} envs x T={T_}, repeat {repeat}, batch {batch}): {len(pairs)} tensors (stats, weights, optimizer state, extra) bit-identical, "
            f"max |diff| 0; replays {replays}")


def modelbased_path(torch, name: str, pendulum=None) -> tuple[dict, list[str]]:
    """``tests/test_modelbased.py``'s test called ``name`` on the card, at its settings: GAIL on Pendulum from the
    Pendulum expert rows (16 + 10 envs, T 128, 5 passes of batch 256, 2 discriminator steps, to -1,100 within 15
    epochs of 10,000), ICM over DQN on CartPole (the CartPole DQN settings, to 195 within 15 epochs), ICM over PPO
    on CartPole (16 + 10 envs, T 128, 10 passes of batch 256, to 195 within 20 epochs), PSRL on ``NChain(5, 0.2)``
    (8 + 8 envs, T 100, 200 value-iteration sweeps, to 340 within 10 epochs of 2,000). The update program is held
    bit-identical to eager first. Returns ({kernel: launches}, report lines)."""
    from tianshou_tpu_torch.algorithm.imitation.gail import GAIL
    from tianshou_tpu_torch.algorithm.modelbased.icm import ICMOffPolicyWrapper, ICMOnPolicyWrapper
    from tianshou_tpu_torch.algorithm.modelbased.psrl import PSRL
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory as Adam
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.classic.nchain import NChain
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic, IntrinsicCuriosityModule
    from tianshou_tpu_torch.models.mlp import Net
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree
    from tianshou_tpu_torch.trainer.trainer import (
        OffPolicyTrainer,
        OffPolicyTrainerParams,
        OnPolicyTrainer,
        OnPolicyTrainerParams,
    )

    threshold = MB_THRESHOLD[name]
    torch.manual_seed(SEED)
    stop = dict(stop_fn=lambda r: r >= threshold, verbose=False)
    if name == "gail_pendulum":
        env, buffer, bs = pendulum
        stored = (torch.arange(buffer.capacity, device=DEV)[None, :] < bs.size[:, None]).reshape(-1)
        algo = GAIL(actor=ContinuousActorProbabilistic((64, 64), 1, input_dim=3),
                    critic=DiscreteCritic((64, 64), input_dim=3), action_space=env.action_space,
                    optim=Adam(lr=3e-4, max_grad_norm=0.5), disc_net=ContinuousCritic((64, 64), input_dim=3, action_dim=1),
                    expert_obs=bs.data.obs.reshape(-1, 3)[stored], expert_act=bs.data.act.reshape(-1, 1)[stored],
                    disc_optim=Adam(lr=1e-3), disc_update_num=2, gamma=0.95, gae_lambda=0.95, eps_clip=0.2,
                    deterministic_eval=True)
        n_train, n_test, T_, kw = 16, 10, 128, dict(max_epochs=15, epoch_num_steps=10000, batch_size=256,
                                                    update_step_num_repetitions=5)
    elif name == "icm_ppo_cartpole":
        env = CartPole()
        algo = ICMOnPolicyWrapper(PPO(actor=DiscreteActor((64, 64), 2, input_dim=4),
                                      critic=DiscreteCritic((64, 64), input_dim=4), action_space=env.action_space,
                                      optim=Adam(lr=3e-4, max_grad_norm=0.5), deterministic_eval=True),
                                  IntrinsicCuriosityModule((64, 32), 2, (64,), input_dim=4), lr_scale=1.0,
                                  reward_scale=0.01, forward_loss_weight=0.2)
        n_train, n_test, T_, kw = 16, 10, 128, dict(max_epochs=20, epoch_num_steps=10000, batch_size=256,
                                                    update_step_num_repetitions=10)
    elif name == "psrl_nchain":
        env = NChain(n=5, slip=0.2)
        algo = PSRL(n_state=5, n_action=2, action_space=env.action_space, gamma=0.95, value_iterations=200)
        n_train, n_test, T_, kw = 8, 8, 100, dict(max_epochs=10, epoch_num_steps=2000, batch_size=1024,
                                                  update_step_num_repetitions=1)
    else:  # icm_dqn_cartpole
        env = CartPole()
        algo = ICMOffPolicyWrapper(DQN(model=Net((64, 64), 2, input_dim=4), action_space=env.action_space,
                                       optim=Adam(lr=1e-3), gamma=0.97, n_step_return_horizon=3, target_update_freq=320,
                                       eps_training=0.3),
                                   IntrinsicCuriosityModule((64, 32), 2, (64,), input_dim=4), lr_scale=1.0,
                                   reward_scale=0.01, forward_loss_weight=0.2)
        buffer, bs = _classic_buffer(torch, env, 20000, 10)
        check = offpolicy_graph_check(torch, name, algo, buffer, bs_example(torch, env), DeviceCollector(
            VectorDeviceEnv(env, 10, device=DEV), algo, buffer), 10, 64, prefill_chunks=10)
        trainer = OffPolicyTrainer(
            algo, DeviceCollector(VectorDeviceEnv(env, 10, device=DEV), algo, buffer),
            DeviceCollector(VectorDeviceEnv(env, 10, device=DEV), algo, None), buffer,
            OffPolicyTrainerParams(max_epochs=15, epoch_num_steps=5000, test_step_num_episodes=10, batch_size=64,
                                   collection_step_num_env_steps=10, update_per_step=0.1, start_steps=1000,
                                   train_fn=lambda ep, step: {"eps_training": max(0.1, 0.3 * (1 - step / 30000))}, **stop))
        run = lambda: trainer.run(algo.init(DEV), bs, torch.Generator(device=DEV).manual_seed(SEED))  # noqa: E731
    if name != "icm_dqn_cartpole":
        check = rollout_graph_check(torch, name, algo, env, n_train, T_, kw["update_step_num_repetitions"],
                                    kw["batch_size"])
        trainer = OnPolicyTrainer(
            algo, DeviceCollector(VectorDeviceEnv(env, n_train, device=DEV), algo, None),
            DeviceCollector(VectorDeviceEnv(env, n_test, device=DEV), algo, None),
            OnPolicyTrainerParams(test_step_num_episodes=n_test, collection_step_num_env_steps=T_, **kw, **stop))
        run = lambda: trainer.run(algo.init(DEV), torch.Generator(device=DEV).manual_seed(SEED))  # noqa: E731
    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()
    res = run()
    launches = _launches(gather, sumtree, physics_fused)
    if not res.best_reward >= threshold:
        raise AssertionError(f"{name} path: best test reward {res.best_reward} after {res.epochs} epochs, below the "
                             f"threshold {threshold}")
    if any(launches.values()) or res.gradient_step != int(res.train_state.step):
        raise AssertionError(f"{name} path: launches {launches}, gradient_step {res.gradient_step}, step "
                             f"{int(res.train_state.step)}")
    t = res.timing
    return launches, [check, (
        f"{name} path: best test reward {res.best_reward:.1f} (threshold {threshold}) after {res.epochs} epochs; "
        f"env_steps {res.env_step} gradient_steps {res.gradient_step}; wall {res.train_time:.2f} s (collect "
        f"{t['collect']:.2f}, update {t['update']:.2f}, test {t['test']:.2f}); capture s "
        f"{ {g.name.split()[0]: round(g.capture_s, 3) for g in trainer.graph_pool.graphs if g.capture_s} }")]


# ---------------------------------------------------------------------------
# the high-level Experiment API, the multi-agent dispatcher and the classic envs (phases 45-50)
# ---------------------------------------------------------------------------
# examples/mujoco/mujoco_sac_hl.py: 16 + 10 envs, a 1 M-row replay, batch 256, one update per env step, 256x256 nets,
# T 10 (OffPolicyTrainingConfig's default); the random prefill cut from 10,000 steps and the epoch from 20,000
HL_SAC_E, HL_SAC_TEST_E, HL_SAC_BUFFER, HL_SAC_BATCH, HL_SAC_HID = 16, 10, 1_000_000, 256, (256, 256)
HL_SAC_PREFILL, HL_SAC_EPOCH = 1_024, 1_024
# examples/mujoco/mujoco_ppo_hl.py: 64 + 10 envs, rollouts of 2,048 steps per env, 10 passes of batch 64; the epoch
# cut from 20,000 steps to 4,096 (one rollout)
HL_PPO_E, HL_PPO_TEST_E, HL_PPO_T, HL_PPO_REPEAT, HL_PPO_BATCH, HL_PPO_EPOCH = 64, 10, 2_048, 10, 64, 4_096
HL_PPO_PROFILE_STEPS = 16  # minibatch steps traced for kernels and device time per gradient step
# examples/marl/tictactoe_selfplay.py: 8 envs, a 20,000-row ring, 500 prefill steps, 200 rounds of 64 steps and one
# update of batch 64; agent 0 against the random policy over 100 episodes must win tests/test_marl.py:40's share
MARL_E, MARL_RING, MARL_PREFILL, MARL_ROUNDS, MARL_T, MARL_BATCH, MARL_EVAL, MARL_BAR = 8, 20_000, 500, 200, 64, 64, 100, 0.7
MARL_REPLAYS = 20
# the classic envs: one vector step at E = 2,048 as a graph against eager; examples/box2d/acrobot_dualdqn.py's setup
# (DuelingNet 128x128, 16 + 10 envs, a 20,000-row ring, lr 1e-3, n 3, target 320, eps 0.73 decayed), one epoch cut
# from 10,000 steps to 2,000
CLASSIC_E, CLASSIC_STEPS, ACRO_E, ACRO_RING, ACRO_EPOCH = 2_048, 8, 16, 20_000, 2_000


def _halfcheetah():
    from tianshou_tpu_torch.env.mujoco import make

    return make("HalfCheetah")


def _cartpole():
    from tianshou_tpu_torch.env.classic.cartpole import CartPole

    return CartPole()


def _per_buffer(num_envs: int):
    from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer

    return PrioritizedVectorReplayBuffer(2000, num_envs, alpha=0.6, beta=0.4)


class _Recording:
    """Records the trainers an ``Experiment`` builds and every test phase's stats, by wrapping the trainer
    base's ``__init__`` and both ``_test`` methods for the ``with`` block (they still run as they were).
    ``cut``: trainer parameters set at each trainer's construction (those its params have), a depth cut where a
    script has no option for it."""

    def __init__(self, cut: dict | None = None) -> None:
        self.cut = cut or {}

    def __enter__(self):
        import dataclasses

        from tianshou_tpu_torch.trainer import trainer as tm

        self.trainers, self.tests = [], []
        self._saved = [(tm._TrainerBase, "__init__", tm._TrainerBase.__init__)]
        self._saved += [(cls, "_test", cls._test) for cls in (tm._TrainerBase, tm._HostTrainerMixin)]
        init = tm._TrainerBase.__init__

        def recording_init(trainer, algo, train_collector, test_collector, params):
            fields = {f.name for f in dataclasses.fields(params)}
            params = dataclasses.replace(params, **{k: v for k, v in self.cut.items() if k in fields})
            init(trainer, algo, train_collector, test_collector, params)
            self.trainers.append(trainer)

        def recording(fn):
            def _test(trainer, ts, generator):
                stats = fn(trainer, ts, generator)
                self.tests.append(stats)
                return stats
            return _test

        tm._TrainerBase.__init__ = recording_init
        for cls, _, fn in self._saved[1:]:
            cls._test = recording(fn)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def _zero_launches():
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree

    for module in (gather, sumtree, physics_fused):
        module.reset_launch_count()


def _read_launches():
    from tianshou_tpu_torch.ops.kernels import gather, physics_fused, sumtree

    return _launches(gather, sumtree, physics_fused)


def _trace_calls(torch, call, n_units: int, replays: int = 5) -> tuple[float, float, float, float]:
    """``call()`` (a graph replay, or eager work) timed between CUDA events (median of ``replays``), then once
    under ``torch.profiler``: (ms per unit between events, kernels per unit, device busy ms per unit, the idle
    share of the untraced time)."""
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    busy = kernels = 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            busy, kernels = busy + e.duration_ns() / 1e6, kernels + 1
    untraced = statistics.median(times)
    if kernels == 0:
        raise AssertionError("the traced call ran no kernel on the device")
    return untraced / n_units, kernels / n_units, busy / n_units, 1 - busy / untraced


def _graphs(trainer) -> dict:
    return {g.name.split()[0]: g for g in trainer.graph_pool.graphs}


def hl_sac_halfcheetah_path(torch):
    """``examples/mujoco/mujoco_sac_hl.py`` through the port's ``SACExperimentBuilder`` (phase 45): the example's
    widths, the depth cut (``HL_SAC_*``). Exactly one ``physics_fused`` launch per vector step, prefill, training and
    test, and no other kernel; the trainer's collect, update and test programs as CUDA graphs; then the builder's
    algorithm in ``offpolicy_graph_check`` (graphs against eager, bit for bit) and the replayed update burst traced.
    Returns ({kernel: launches}, lines)."""
    import numpy as np

    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.highlevel.config import ExperimentConfig, OffPolicyTrainingConfig
    from tianshou_tpu_torch.highlevel.experiment import SACExperimentBuilder
    from tianshou_tpu_torch.highlevel.module import ActorFactoryDefault, CriticFactoryDefault
    from tianshou_tpu_torch.highlevel.params import SACParams

    training = OffPolicyTrainingConfig(max_epochs=1, epoch_num_steps=HL_SAC_EPOCH, num_train_envs=HL_SAC_E,
                                       num_test_envs=HL_SAC_TEST_E, buffer_size=HL_SAC_BUFFER,
                                       start_timesteps=HL_SAC_PREFILL, start_timesteps_random=True,
                                       batch_size=HL_SAC_BATCH, update_step_num_gradient_steps_per_sample=1.0)
    builder = (SACExperimentBuilder(_halfcheetah, ExperimentConfig(seed=SEED, persistence_enabled=False), training)
               .with_params(SACParams(actor_lr=1e-3, critic_lr=1e-3, alpha=0.2, tau=0.005))
               .with_actor_factory(ActorFactoryDefault(hidden_sizes=HL_SAC_HID, conditioned_sigma=True))
               .with_critic_factory(CriticFactoryDefault(hidden_sizes=HL_SAC_HID, use_action=True)))
    exp = builder.build()
    _zero_launches()
    with _Recording() as rec:
        res = exp.run("hl_sac_halfcheetah", device=DEV)
    torch.cuda.synchronize()
    launches = _read_launches()
    (trainer,) = rec.trainers
    T, E = training.collection_step_num_env_steps, HL_SAC_E
    chunk = T * E
    n_updates = round(chunk * training.update_step_num_gradient_steps_per_sample)
    prefill_chunks, chunks = -(-HL_SAC_PREFILL // chunk), -(-HL_SAC_EPOCH // chunk)
    train_steps = (prefill_chunks + chunks) * T
    test_steps = sum(s.n_collected_steps for s in rec.tests) // HL_SAC_TEST_E
    expect = {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": train_steps + test_steps}
    if launches != expect:
        raise AssertionError(f"hl_sac_halfcheetah: launches {launches}, expected {expect} ({train_steps} train and "
                             f"{test_steps} test vector steps)")
    ts = res.train_state
    if res.env_step != train_steps * E or res.gradient_step != chunks * n_updates or int(ts.step) != res.gradient_step:
        raise AssertionError(f"hl_sac_halfcheetah: env_step {res.env_step}, gradient_step {res.gradient_step}")
    graphs = _graphs(trainer)
    if sorted(graphs) != ["collect_chunk", "test_chunk", "update_burst"] or graphs["update_burst"].replays != chunks - 1:
        raise AssertionError(f"hl_sac_halfcheetah: programs { {n: g.replays for n, g in graphs.items()} }")
    if len(rec.tests) != 1 or rec.tests[0].n_collected_episodes != HL_SAC_TEST_E or not np.isfinite(rec.tests[0].returns).all():
        raise AssertionError(f"hl_sac_halfcheetah: test phases {[(s.n_collected_episodes, s.returns) for s in rec.tests]}")
    if not all(bool(torch.isfinite(p).all()) for p in ts.model.parameters()):
        raise AssertionError("hl_sac_halfcheetah: non-finite weights")
    per_update, kernels, busy, idle = _trace_calls(torch, graphs["update_burst"], n_updates)
    # the builder's algorithm: the trainer's programs as graphs against eager, bit for bit
    torch.manual_seed(SEED)
    env = _halfcheetah()
    algo = exp.algo_factory(env)
    buffer = VectorReplayBuffer(HL_SAC_BUFFER, E)
    check = offpolicy_graph_check(torch, "hl_sac_halfcheetah", algo, buffer, bs_example(torch, env),
                                  DeviceCollector(VectorDeviceEnv(env, E, device=DEV), algo, buffer), T, HL_SAC_BATCH,
                                  prefill_chunks=2)
    t = res.timing
    return launches, [
        f"hl_sac_halfcheetah path: SACExperimentBuilder, E={E} T={T} batch {HL_SAC_BATCH} nets {HL_SAC_HID}, {n_updates} "
        f"updates per chunk, replay of {HL_SAC_BUFFER} rows; prefill {prefill_chunks * chunk} random steps, 1 epoch of "
        f"{chunks * chunk} steps (cut from 10,000 and 20,000); test reward {float(rec.tests[0].returns.mean()):.3f}; "
        f"launches {launches} = {train_steps} train + {test_steps} test vector steps; wall {res.train_time:.2f} s (prefill "
        f"{t['prefill']:.2f}, collect {t['collect']:.2f}, update {t['update']:.2f}, test {t['test']:.2f})",
        f"hl_sac_halfcheetah path: one replayed update burst of {n_updates} updates: {per_update:.4f} ms per update "
        f"between CUDA events, kernels per update {kernels:.1f}, device ms per update {busy:.4f}, idle share {idle:.4f}; "
        f"replays { {n: g.replays for n, g in graphs.items()} }",
        check,
    ]


def hl_ppo_halfcheetah_path(torch):
    """``examples/mujoco/mujoco_ppo_hl.py`` through the port's ``PPOExperimentBuilder`` (phase 46): the example's
    widths, the epoch cut to one rollout (``HL_PPO_*``). Exactly one ``physics_fused`` launch per vector step, train
    and test, no other kernel; the gradient-step count; the rollout's update through the trainer's step graphs (the
    first step eager, the rest replays of one step's graph), which ``rollout_graph_check`` holds to the eager update bit for bit; then
    ``HL_PPO_PROFILE_STEPS`` replayed minibatch steps of the trained algorithm traced for kernels and device time per
    gradient step. Returns ({kernel: launches}, lines)."""
    import copy

    import numpy as np

    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.highlevel.config import ExperimentConfig, OnPolicyTrainingConfig
    from tianshou_tpu_torch.highlevel.experiment import PPOExperimentBuilder
    from tianshou_tpu_torch.highlevel.params import PPOParams
    from tianshou_tpu_torch.utils.graph import StepGraphs

    training = OnPolicyTrainingConfig(max_epochs=1, epoch_num_steps=HL_PPO_EPOCH, num_train_envs=HL_PPO_E,
                                      num_test_envs=HL_PPO_TEST_E, collection_step_num_env_steps=HL_PPO_T,
                                      update_step_num_repetitions=HL_PPO_REPEAT, batch_size=HL_PPO_BATCH)
    exp = (PPOExperimentBuilder(_halfcheetah, ExperimentConfig(seed=SEED, persistence_enabled=False), training)
           .with_params(PPOParams(lr=3e-4, eps_clip=0.2, gae_lambda=0.95, advantage_normalization=True, ent_coef=0.0))
           .build())
    _zero_launches()
    with _Recording() as rec:
        res = exp.run("hl_ppo_halfcheetah", device=DEV)
    torch.cuda.synchronize()
    launches = _read_launches()
    (trainer,) = rec.trainers
    rollouts = -(-HL_PPO_EPOCH // (HL_PPO_T * HL_PPO_E))
    test_steps = sum(s.n_collected_steps for s in rec.tests) // HL_PPO_TEST_E
    expect = {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0,
              "physics_fused": rollouts * HL_PPO_T + test_steps}
    if launches != expect:
        raise AssertionError(f"hl_ppo_halfcheetah: launches {launches}, expected {expect}")
    algo, ts = trainer.algo, res.train_state
    n_grad = rollouts * algo.rollout_grad_steps(HL_PPO_T * HL_PPO_E, HL_PPO_REPEAT, HL_PPO_BATCH)
    if res.gradient_step != n_grad or int(ts.step) != n_grad or res.env_step != rollouts * HL_PPO_T * HL_PPO_E:
        raise AssertionError(f"hl_ppo_halfcheetah: gradient_step {res.gradient_step} step {int(ts.step)}, expected {n_grad}")
    if len(rec.tests) != 1 or not np.isfinite(rec.tests[0].returns).all() or \
            not all(bool(torch.isfinite(p).all()) for p in ts.model.parameters()):
        raise AssertionError("hl_ppo_halfcheetah: a non-finite test return or weight")
    sg = trainer.step_graphs  # the rollout's update: its first step eager, the rest replays of one step's graph
    if sg is None or (sg.captures, sg.replays) != (1, n_grad // rollouts - 1):
        raise AssertionError(f"hl_ppo_halfcheetah: the update's step graphs {sg and (sg.captures, sg.replays)}")
    env = _halfcheetah()
    check = rollout_graph_check(torch, "hl_ppo_halfcheetah", algo, env, HL_PPO_E, HL_PPO_PROFILE_STEPS, 2,
                                HL_PPO_BATCH, step_graphs=True)
    # kernels and device time per gradient step: replayed minibatch steps of a copy of the trained state on a
    # fresh rollout
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    ts2 = copy.deepcopy(ts)
    coll = DeviceCollector(VectorDeviceEnv(env, HL_PPO_E, device=DEV), algo, None)
    roll = coll.rollout(ts2, coll.reset(gen), None, gen, HL_PPO_PROFILE_STEPS, keep_rollout=True).rollout
    batch = algo.process_rollout(ts2, roll)
    perm = algo.minibatch_indices(HL_PPO_PROFILE_STEPS * HL_PPO_E, 1, HL_PPO_BATCH, gen, torch.device(DEV))
    with StepGraphs(DEV, (gen,)):
        algo.run_minibatch_updates(ts2, batch, 1, HL_PPO_BATCH, gen, perm)  # the step's warm-up and capture
        per_step, kernels, busy, idle = _trace_calls(torch, lambda: algo.run_minibatch_updates(
            ts2, batch, 1, HL_PPO_BATCH, gen, perm), perm.shape[1])
    t = res.timing
    return launches, [
        f"hl_ppo_halfcheetah path: PPOExperimentBuilder, E={HL_PPO_E} T={HL_PPO_T} repeat {HL_PPO_REPEAT} batch "
        f"{HL_PPO_BATCH}, {rollouts} rollout of {HL_PPO_T * HL_PPO_E} rows (the epoch cut from 20,000 steps), {n_grad} "
        f"gradient steps; test reward {float(rec.tests[0].returns.mean()):.3f}; launches {launches} = "
        f"{rollouts * HL_PPO_T} train + {test_steps} test vector steps; wall {res.train_time:.2f} s (collect "
        f"{t['collect']:.2f}, update {t['update']:.2f} = {t['update'] / n_grad * 1e3:.4f} ms per gradient step: "
        f"step graphs, {sg.captures} captured and {sg.replays} replays; test {t['test']:.2f})",
        check,
        f"hl_ppo_halfcheetah path: {perm.shape[1]} replayed minibatch steps traced: {per_step:.4f} ms per gradient "
        f"step between CUDA events, kernels per gradient step {kernels:.1f}, device ms per gradient step {busy:.4f}, "
        f"idle share {idle:.4f}",
    ]


def hl_dqn_cartpole_path(torch):
    """``tests/test_highlevel.py:34-55`` on the card (phase 47), nothing cut: DQN through the builder with persistence
    on must reach 195 and write ``best`` and ``experiment.pkl``; ``Experiment.from_directory`` re-runs it; the ``best``
    checkpoint restores into a fresh train state bit for bit. No kernel. Returns ({kernel: launches}, lines)."""
    import os

    from tianshou_tpu_torch.highlevel.config import ExperimentConfig, OffPolicyTrainingConfig
    from tianshou_tpu_torch.highlevel.experiment import DQNExperimentBuilder, Experiment
    from tianshou_tpu_torch.utils.persistence import restore_train_state

    with tempfile.TemporaryDirectory() as root:
        training = OffPolicyTrainingConfig(max_epochs=12, epoch_num_steps=5000, buffer_size=20000, num_train_envs=10,
                                           num_test_envs=10, start_timesteps=1000, stop_threshold=195)
        exp = (DQNExperimentBuilder(_cartpole, ExperimentConfig(seed=SEED, persistence_base_dir=root), training)
               .with_dqn_params(gamma=0.97, n_step_return_horizon=3, target_update_freq=320, eps_training=0.3)
               .build())
        _zero_launches()
        res = exp.run("dqn_cartpole", device=DEV)
        launches = _read_launches()
        run_dir = f"{root}/dqn_cartpole"
        if not res.best_reward >= 195 or not os.path.isfile(f"{run_dir}/experiment.pkl") or \
                not os.path.isdir(f"{run_dir}/best"):
            raise AssertionError(f"hl_dqn_cartpole: best {res.best_reward}, files {os.listdir(run_dir)}")
        saved = torch.load(f"{run_dir}/best/train_state.pt", map_location=DEV, weights_only=False)
        fresh = exp.algo_factory(_cartpole()).init(DEV)
        restored = restore_train_state(f"{run_dir}/best", fresh)
        pairs = [(restored.model.state_dict()[k], v) for k, v in saved["model"].items()]
        pairs += [(restored.target.state_dict()[k], v) for k, v in saved["target"].items()]
        pairs += [(restored.step, saved["step"])] + [(restored.hparams[k], v) for k, v in saved["hparams"].items()]
        opt = restored.optim.state_dict()["state"]
        pairs += [(opt[i][k], v) for i, st in saved["optim"]["state"].items() for k, v in st.items()]
        if any(not torch.equal(a, b) for a, b in pairs):
            raise AssertionError("hl_dqn_cartpole: the restored best train state differs from the saved one")
        again = Experiment.from_directory(run_dir)
        res2 = again.run("dqn_cartpole_again", device=DEV)
        if res2.env_step <= 0 or not os.path.isdir(f"{root}/dqn_cartpole_again/best"):
            raise AssertionError("hl_dqn_cartpole: from_directory's experiment did not run")
    if launches != {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": 0}:
        raise AssertionError(f"hl_dqn_cartpole: launches {launches}")
    return launches, [
        f"hl_dqn_cartpole path: best test reward {res.best_reward:.1f} (threshold 195) after {res.epochs} epochs, "
        f"{res.env_step} env steps, wall {res.train_time:.2f} s; best and experiment.pkl written; the best "
        f"checkpoint restored into a fresh train state: {len(pairs)} tensors bit-identical; from_directory re-ran: best "
        f"{res2.best_reward:.1f} after {res2.epochs} epochs ({'the same run' if res2.best_reward == res.best_reward and res2.env_step == res.env_step else 'another run'})",
    ]


def hl_dqn_cartpole_per_path(torch):
    """``tests/test_highlevel.py:270-278`` on the card (phase 48): DQN through the builder over
    ``PrioritizedVectorReplayBuffer(2000, n, alpha=0.6, beta=0.4)`` (``with_buffer_factory``): one descent per
    update, one tree update per update and per collect step, the final tree exactly consistent and both kernels
    on it against their plain versions (``_check_tree``). Returns ({kernel: launches}, lines)."""
    from tianshou_tpu_torch.highlevel.config import ExperimentConfig, OffPolicyTrainingConfig
    from tianshou_tpu_torch.highlevel.experiment import DQNExperimentBuilder

    training = OffPolicyTrainingConfig(max_epochs=1, epoch_num_steps=400, buffer_size=2000, num_train_envs=4,
                                       num_test_envs=4, start_timesteps=100, test_step_num_episodes=2, batch_size=32)
    exp = (DQNExperimentBuilder(_cartpole, ExperimentConfig(seed=SEED, persistence_enabled=False), training)
           .with_dqn_params(eps_training=0.3).with_buffer_factory(_per_buffer).build())
    _zero_launches()
    with _Recording() as rec:
        res = exp.run("per", device=DEV)
    torch.cuda.synchronize()
    launches = _read_launches()
    (trainer,) = rec.trainers
    vector_steps = res.env_step // training.num_train_envs
    expect = {"gather_rows": 0, "prefix_sum_idx": res.gradient_step, "tree_update": res.gradient_step + vector_steps,
              "physics_fused": 0}
    if launches != expect or res.gradient_step == 0:
        raise AssertionError(f"hl_dqn_cartpole_per: launches {launches}, expected {expect}")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    return launches, [
        f"hl_dqn_cartpole_per path: {res.env_step} env steps ({vector_steps} vector steps, prefill included), "
        f"{res.gradient_step} updates; launches {launches}",
        "hl_dqn_cartpole_per path: " + _check_tree(torch, trainer.buffer, res.buf_state, gen, training.batch_size),
    ]


def _board_dqn(torch):
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.env.core import Discrete
    from tianshou_tpu_torch.models.discrete import MaskedQNet

    return DQN(model=MaskedQNet((128, 128), 9, input_dim=18), action_space=Discrete(9),
               optim=AdamOptimizerFactory(lr=1e-3), gamma=0.9, n_step_return_horizon=1, target_update_freq=200,
               eps_training=0.2)


def _board_example(torch):
    from tianshou_tpu_torch.data.batch import Batch

    obs = Batch(agent_id=torch.tensor(0, dtype=torch.int32), obs=torch.zeros(3, 3, 2), mask=torch.ones(9, dtype=torch.bool))
    return Batch(obs=obs, act=torch.tensor(0), rew=torch.zeros(2), terminated=torch.tensor(False),
                 truncated=torch.tensor(False), obs_next=obs.map(torch.clone))


def marl_tictactoe_path(torch):
    """``examples/marl/tictactoe_selfplay.py`` on the card (phase 49): two DQN agents over ``MaskedQNet(128, 128)``
    in self-play through ``HostOffPolicyTrainer`` (the host TicTacToe envs, the update burst a CUDA graph; the
    example's ``MARL_*`` settings); agent 0 against ``MARLRandomPolicy`` must win at least ``MARL_BAR`` of
    ``MARL_EVAL`` episodes. Then the update as a graph against eager (``offline_graph_check``), its replay traced, and
    the same self-play through ``MARLExperimentBuilder``, held to the same bar. No kernel. Returns ({kernel: launches},
    lines)."""
    import numpy as np

    from tianshou_tpu_torch.algorithm.multiagent.marl import MARLRandomPolicy, MultiAgentOffPolicyAlgorithm
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.core import Discrete
    from tianshou_tpu_torch.env.tictactoe import TicTacToeEnv
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv
    from tianshou_tpu_torch.highlevel.config import ExperimentConfig, OffPolicyTrainingConfig
    from tianshou_tpu_torch.highlevel.experiment import MARLExperimentBuilder
    from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer, OffPolicyTrainerParams

    torch.manual_seed(SEED)
    marl = MultiAgentOffPolicyAlgorithm([_board_dqn(torch), _board_dqn(torch)], action_space=Discrete(9))
    ts = marl.init(DEV)
    buffer = VectorReplayBuffer(MARL_RING, MARL_E)
    bs = buffer.init(_board_example(torch), device=DEV)
    tcol = HostCollector(DummyVectorEnv([TicTacToeEnv for _ in range(MARL_E)]), marl, buffer, device=DEV)
    ecol = HostCollector(DummyVectorEnv([TicTacToeEnv for _ in range(MARL_E)]), marl, None, device=DEV)
    params = OffPolicyTrainerParams(max_epochs=1, epoch_num_steps=MARL_ROUNDS * MARL_T, batch_size=MARL_BATCH,
                                    collection_step_num_env_steps=MARL_T // MARL_E, update_per_step=1 / MARL_T,
                                    start_steps=MARL_PREFILL, start_random=False, verbose=False, seed=SEED)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    _zero_launches()
    trainer = HostOffPolicyTrainer(marl, tcol, ecol, buffer, params)
    res = trainer.run(ts, bs, gen)
    torch.cuda.synchronize()
    if res.gradient_step != MARL_ROUNDS or any(int(t.step) != MARL_ROUNDS for t in ts.values()):
        raise AssertionError(f"marl_tictactoe: gradient_step {res.gradient_step}, steps {[int(t.step) for t in ts.values()]}")
    rp = MARLRandomPolicy(Discrete(9))

    def win_rate(agent, agent_ts, who: str) -> tuple[float, float]:
        """Agent 0 against the random policy over ``MARL_EVAL`` episodes: (wins, losses) as shares."""
        ev = MultiAgentOffPolicyAlgorithm([agent, rp], action_space=Discrete(9))
        ec = HostCollector(DummyVectorEnv([TicTacToeEnv for _ in range(MARL_E)]), ev, None, device=DEV)
        ec.reset(seed=1)
        stats = ec.collect({"agent0": agent_ts, "agent1": rp.init(DEV)}, gen, n_episode=MARL_EVAL, training=False)
        win, loss = float((stats.returns > 0).mean()), float((stats.returns < 0).mean())
        if not win >= MARL_BAR or stats.n_collected_episodes != MARL_EVAL:
            raise AssertionError(f"marl_tictactoe ({who}): win rate {win} (losses {loss}) over "
                                 f"{stats.n_collected_episodes} episodes, below {MARL_BAR}")
        return win, loss

    win, loss = win_rate(marl.algorithms[0], ts["agent0"], "direct")
    graph = _graphs(trainer)["update_burst"]
    per_update, kernels, busy, idle = _trace_calls(torch, graph, 1, MARL_REPLAYS)
    check = offline_graph_check(torch, "marl_tictactoe", marl, buffer, tcol.buf_state, MARL_BATCH)
    # the same self-play through MARLExperimentBuilder (its default agents are _board_dqn's), held to the same bar
    t0 = time.perf_counter()
    with _Recording() as rec:
        built = (MARLExperimentBuilder(TicTacToeEnv, n_agents=2, config=ExperimentConfig(seed=SEED, persistence_enabled=False),
                                       training=OffPolicyTrainingConfig(
                                           max_epochs=1, epoch_num_steps=MARL_ROUNDS * MARL_T, buffer_size=MARL_RING,
                                           num_train_envs=MARL_E, num_test_envs=MARL_E, test_step_num_episodes=MARL_E,
                                           batch_size=MARL_BATCH, collection_step_num_env_steps=MARL_T // MARL_E,
                                           update_step_num_gradient_steps_per_sample=1 / MARL_T,
                                           start_timesteps=MARL_PREFILL, start_timesteps_random=False))
                 .build().run("marl_builder", device=DEV))
    built_s = time.perf_counter() - t0
    if built.gradient_step != MARL_ROUNDS or any(int(t.step) != MARL_ROUNDS for t in built.train_state.values()):
        raise AssertionError(f"marl_tictactoe: the builder's run took {built.env_step} steps, {built.gradient_step} updates")
    b_win, b_loss = win_rate(rec.trainers[0].algo.algorithms[0], built.train_state["agent0"], "builder")
    launches = _read_launches()
    if any(launches.values()):
        raise AssertionError(f"marl_tictactoe: launches {launches}")
    tm = res.timing
    return launches, [
        f"marl_tictactoe path: self-play of two DQNs over MaskedQNet(128, 128), {MARL_E} envs, {MARL_PREFILL} prefill "
        f"steps, {MARL_ROUNDS} rounds of {MARL_T} steps and 1 update of batch {MARL_BATCH}; agent 0 against the random "
        f"policy: win rate {win:.3f} (bar {MARL_BAR}), losses {loss:.3f}, over {MARL_EVAL} episodes; wall "
        f"{res.train_time:.2f} s (prefill {tm['prefill']:.2f}, collect {tm['collect']:.2f}, update {tm['update']:.2f}, "
        f"test {tm['test']:.2f}); launches {launches}",
        f"marl_tictactoe path: the replayed multi-agent update: {per_update:.4f} ms between CUDA events, kernels per "
        f"update {kernels:.1f}, device ms per update {busy:.4f}, idle share {idle:.4f}",
        check,
        f"marl_tictactoe path: MARLExperimentBuilder at the same settings ran {built.env_step} env steps and "
        f"{built.gradient_step} updates in {built_s:.2f} s; agent 0 against the random policy: win rate {b_win:.3f} "
        f"(bar {MARL_BAR}), losses {b_loss:.3f}",
    ]


def classic_envs_phase(torch):
    """The classic envs (phase 50): ``CLASSIC_STEPS`` vector steps of ``Acrobot``, ``MountainCar`` and
    ``MountainCarContinuous`` at E = ``CLASSIC_E`` as one CUDA graph against the same steps eager, from one reset and
    the same actions: states, observations, rewards and flags bit-identical. Then
    ``examples/box2d/acrobot_dualdqn.py``'s setup for one cut epoch through ``OffPolicyTrainer``. No kernel.
    Returns ({kernel: launches}, lines)."""
    import numpy as np

    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.acrobot import Acrobot
    from tianshou_tpu_torch.env.classic.mountain_car import MountainCar, MountainCarContinuous
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.models.mlp import DuelingNet
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams
    from tianshou_tpu_torch.utils.tree import tree_map

    _zero_launches()
    lines = []
    for env in (Acrobot(), MountainCar(), MountainCarContinuous()):
        venv = VectorDeviceEnv(env, CLASSIC_E, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        start, _ = venv.reset(gen)
        acts = [venv.action_space.sample(CLASSIC_E, gen, DEV) for _ in range(CLASSIC_STEPS)]

        def steps(state):
            outs = []
            for a in acts:
                out = venv.step(state, a, gen)
                outs.append(out)
                state = out.state
            return outs

        eager = steps(start)
        static = tree_map(torch.clone, start)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            steps(static)  # warm-up
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = steps(static)
        graph.replay()
        torch.cuda.synchronize()
        pairs = [(x, y) for a, b in zip(captured, eager) for x, y in zip(_leaves([a.state, a.obs, a.reward, a.terminated,
                                                                                   a.truncated]),
                                                                           _leaves([b.state, b.obs, b.reward, b.terminated,
                                                                                    b.truncated]))]
        differ = sum(not torch.equal(x, y) for x, y in pairs)
        if differ or not all(bool(torch.isfinite(o.obs).all()) for o in eager):
            raise AssertionError(f"classic_envs {env.name}: {differ} of {len(pairs)} tensors differ from eager")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            graph.replay()
        b.record()
        b.synchronize()
        lines.append(f"classic_envs {env.name}: {CLASSIC_STEPS} vector steps at E={CLASSIC_E} as a graph against eager: "
                     f"{len(pairs)} tensors bit-identical, max |diff| 0; {a.elapsed_time(b) / 10 / CLASSIC_STEPS * 1e3:.2f} "
                     f"us per vector step replayed; terminations {int(sum(o.terminated.sum() for o in eager))}")
    torch.manual_seed(SEED)
    env = Acrobot()
    algo = DQN(model=DuelingNet((128, 128), 3, input_dim=6), action_space=env.action_space,
               optim=AdamOptimizerFactory(lr=1e-3), gamma=0.99, n_step_return_horizon=3, target_update_freq=320,
               eps_training=0.73)
    ts = algo.init(DEV)
    buffer = VectorReplayBuffer(ACRO_RING, ACRO_E)
    bs = buffer.init(bs_example(torch, env), device=DEV)
    params = OffPolicyTrainerParams(
        max_epochs=1, epoch_num_steps=ACRO_EPOCH, test_step_num_episodes=10, batch_size=64,
        collection_step_num_env_steps=10, update_per_step=0.1, start_steps=1000, stop_fn=lambda r: r >= -80,
        train_fn=lambda ep, step: {"eps_training": max(0.1, 0.73 * (1 - step / 50_000))}, verbose=False, seed=SEED)
    with _Recording() as rec:
        res = OffPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, ACRO_E, device=DEV), algo, buffer),
                               DeviceCollector(VectorDeviceEnv(env, 10, device=DEV), algo, None), buffer,
                               params).run(ts, bs, torch.Generator(device=DEV).manual_seed(SEED))
    torch.cuda.synchronize()
    launches = _read_launches()
    if any(launches.values()) or len(rec.tests) != 1 or not np.isfinite(rec.tests[0].returns).all() or res.gradient_step == 0:
        raise AssertionError(f"classic_envs acrobot: launches {launches}, tests {len(rec.tests)}, updates {res.gradient_step}")
    lines.append(f"classic_envs acrobot_dualdqn: DuelingNet(128, 128), {ACRO_E} envs, a {ACRO_RING}-row ring, 1 epoch of "
                 f"{ACRO_EPOCH} steps (cut from 10,000): test reward {float(rec.tests[0].returns.mean()):.1f} (10 episodes), "
                 f"{res.env_step} env steps, {res.gradient_step} updates, wall {res.train_time:.2f} s; launches {launches}")
    return launches, lines


# ---------------------------------------------------------------------------
# the mesh programs at world size 1 on NCCL, and the multi-seed launchers (phases 51-55)
# ---------------------------------------------------------------------------
DP_CHUNKS, DP_T = 2, 4               # dp_dqn_pixels: chunks of the pixel pipeline through each program, env steps a
                                     # chunk (half the DQN path's T: a chunk's eager run leads the phase's time)
DP_PPO_T, DP_PPO_CALLS = 32, 2       # dp_ppo_halfcheetah: bench_mujoco_ppo's rollout, and rollouts per program
DP_TR_CALLS = 2                      # dp_trpo_halfcheetah: rollouts (T = TR_T) through each program
DP_SAC_CHUNKS, DP_SAC_PREFILL = 2, 16  # dp_sac_halfcheetah: chunks through each program, random prefill steps
SEEDED = (0, 1)                      # seeded_eval: the seeds of hl_dqn_cartpole_per's builder run


def _time_call(torch, fn):
    """``fn()`` and its wall in ms, the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _mesh_of_one(torch):
    """A one-rank NCCL group and its 1-D mesh (``make_mesh(1)`` in a process that never called ``initialize``)."""
    import torch.distributed as dist

    from tianshou_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, device=DEV)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"the mesh's group is {dist.get_backend()} of {dist.get_world_size()} ranks, not NCCL of 1")
    return mesh


def _group_down():
    import torch.distributed as dist

    dist.destroy_process_group()


def _differing(torch, pairs) -> int:
    return sum(not torch.equal(a, b) for a, b in pairs)


def dp_dqn_pixels_phase(torch):
    """Phase 51: ``make_dp_offpolicy_train_step`` at world size 1 on NCCL over the ``bench.py`` DQN pixel pipeline at
    full width (``build_pipeline(torch, "dqn")``: E = 256, the uint8 rings, ``DQNet(6)``, batch 32), in chunks of
    T = ``DP_T`` env steps (102 updates a chunk). From one prefilled state and generator state, deep copies run
    ``DP_CHUNKS`` chunks through ``OffPolicyTrainer.megastep`` (eager warm-up, then capture and replay) and through the mesh step, eagerly; every
    tensor of the train state, the optimizer, the rings, the collect state and the stats, and the generator, must be
    bit-identical (cuDNN deterministic), and ``gather_rows`` must run exactly twice per update of the mesh step.
    Returns ({kernel: launches} of the mesh step, lines)."""
    import copy

    from tianshou_tpu_torch.parallel.mesh import make_dp_offpolicy_train_step
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    algo, ts, buffer, bs, coll = build_pipeline(torch, "dqn")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    coll.collect(ts, cstate, bs, gen, DP_T, random=True)  # a prefill chunk: DP_T rows per env to sample from
    n_updates = max(1, round(0.1 * DP_T * E))
    sides = {}
    for side in ("trainer", "mesh"):
        s_ts, s_bs, s_cs = copy.deepcopy((ts, bs, cstate))
        s_gen = torch.Generator(device="cuda")
        s_gen.set_state(gen.get_state())
        sides[side] = dict(ts=s_ts, bs=s_bs, cstate=s_cs, gen=s_gen, walls=[], stats=[])
    del ts, bs, cstate
    tr, md = sides["trainer"], sides["mesh"]
    trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(
        batch_size=BATCH, collection_step_num_env_steps=DP_T, fused_megastep=True, verbose=False))
    for _ in range(DP_CHUNKS):
        (_, burst), ms = _time_call(torch, lambda: trainer.megastep(tr["ts"], tr["cstate"], tr["bs"], tr["gen"], DP_T,
                                                                   n_updates))
        tr["walls"].append(ms)
        tr["stats"].append(burst.map(torch.clone))
    mesh = _mesh_of_one(torch)
    step = make_dp_offpolicy_train_step(algo, coll, buffer, mesh, DP_T, n_updates, BATCH)
    _zero_launches()
    for _ in range(DP_CHUNKS):
        out, ms = _time_call(torch, lambda: step(md["ts"], md["cstate"], md["bs"], md["gen"]))
        md["walls"].append(ms)
        md["stats"].append(out[4].map(torch.clone))
    launches = _read_launches()
    _group_down()
    pairs = [(a, b) for x, y in zip(tr["stats"], md["stats"]) for k in x.keys() for a, b in [(x[k], y[k])]]
    pairs += list(zip(tr["ts"].model.state_dict().values(), md["ts"].model.state_dict().values()))
    pairs += list(zip(tr["ts"].target.state_dict().values(), md["ts"].target.state_dict().values()))
    pairs += list(zip(_optimizer_state(tr["ts"]), _optimizer_state(md["ts"])))
    pairs += [(tr["ts"].step, md["ts"].step), *zip(tr["ts"].hparams.values(), md["ts"].hparams.values())]
    pairs += [(getattr(tr["bs"], k), getattr(md["bs"], k)) for k in ("cursor", "size", "last_idx")]
    pairs += list(zip(tr["bs"].data.values(), md["bs"].data.values()))
    pairs += list(zip(_leaves(tr["cstate"]), _leaves(md["cstate"])))
    pairs += [(tr["gen"].get_state(), md["gen"].get_state())]
    differ = _differing(torch, pairs)
    updates = DP_CHUNKS * n_updates
    _, replay_ms = _time_call(torch, lambda: trainer.megastep(tr["ts"], tr["cstate"], tr["bs"], tr["gen"], DP_T,
                                                              n_updates))
    torch.backends.cudnn.deterministic = deterministic
    expect = {"gather_rows": 2 * updates, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": 0}
    if differ or int(md["ts"].step) != updates:
        raise AssertionError(f"dp_dqn_pixels: {differ} of {len(pairs)} tensors differ from OffPolicyTrainer.megastep, "
                             f"step {int(md['ts'].step)} of {updates}")
    if launches != expect:
        raise AssertionError(f"dp_dqn_pixels: launches {launches}, expected {expect}")
    return launches, [
        f"dp_dqn_pixels: make_dp_offpolicy_train_step at world size 1 on NCCL, E={E}, rings uint8 "
        f"{tuple(md['bs'].data.obs.shape)}, {DP_CHUNKS} chunks of T={DP_T} and {n_updates} updates of batch {BATCH}: "
        f"{len(pairs)} tensors (stats, weights, target, Adam, counters, rings, collect state, generator) bit-identical "
        f"to OffPolicyTrainer.megastep; gather_rows {launches['gather_rows']} = 2 per update",
        f"dp_dqn_pixels: wall per chunk: the mesh step, eager, {md['walls'][0]:.1f} / {md['walls'][1]:.1f} ms; the "
        f"trainer's megastep {tr['walls'][0]:.1f} (eager warm-up) / {tr['walls'][1]:.1f} (capture and replay) / "
        f"{replay_ms:.1f} ms (replay)",
    ]


def dp_ppo_halfcheetah_phase(torch):
    """Phase 52: ``make_dp_train_step`` at world size 1 on NCCL over ``build_ppo(torch, "HalfCheetah", 2048)``
    (``bench_mujoco_ppo``: T = 32, 4 passes of batch 16,384). From one state and generator state, deep copies run
    ``DP_PPO_CALLS`` rollouts with their updates through ``OnPolicyTrainer``'s ``collect_chunk`` and
    ``update_rollout`` programs and through the mesh step, eagerly: the collect states (the normalization statistics
    included), weights, Adam's state, the return statistics, the stats and the generator bit-identical, and
    ``physics_fused`` exactly once per vector step of the mesh step. Returns ({kernel: launches}, lines)."""
    import copy

    from tianshou_tpu_torch.parallel.mesh import make_dp_train_step
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    algo, ts, coll = build_ppo(torch, "HalfCheetah", PPO_E)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    sides = {}
    for side in ("trainer", "mesh"):
        s_ts, s_cs = copy.deepcopy((ts, cstate))
        s_gen = torch.Generator(device="cuda")
        s_gen.set_state(gen.get_state())
        sides[side] = dict(ts=s_ts, cstate=s_cs, gen=s_gen, walls=[], stats=[])
    del ts, cstate
    tr, md = sides["trainer"], sides["mesh"]
    trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(
        batch_size=PPO_BATCH, collection_step_num_env_steps=DP_PPO_T, update_step_num_repetitions=PPO_REPEAT,
        verbose=False))

    def trainer_call():
        out = trainer.collect_chunk(tr["ts"], tr["cstate"], None, tr["gen"], DP_PPO_T, keep_rollout=True)
        return trainer.update_rollout(tr["ts"], out.rollout, tr["gen"])

    for _ in range(DP_PPO_CALLS):
        stats, ms = _time_call(torch, trainer_call)
        tr["walls"].append(ms)
        tr["stats"].append(stats.map(torch.clone))
    mesh = _mesh_of_one(torch)
    step = make_dp_train_step(algo, coll, mesh, DP_PPO_T, PPO_REPEAT, PPO_BATCH)
    _zero_launches()
    for _ in range(DP_PPO_CALLS):
        out, ms = _time_call(torch, lambda: step(md["ts"], md["cstate"], md["gen"]))
        md["walls"].append(ms)
        md["stats"].append(out[2].map(torch.clone))
    launches = _read_launches()
    _group_down()
    pairs = [(x[k], y[k]) for x, y in zip(tr["stats"], md["stats"]) for k in x.keys()]
    pairs += list(zip(_onpolicy_tensors(torch, tr["ts"], tr["cstate"]), _onpolicy_tensors(torch, md["ts"], md["cstate"])))
    pairs += [(tr["gen"].get_state(), md["gen"].get_state())]
    differ = _differing(torch, pairs)
    replay_ms = [_time_call(torch, trainer_call)[1] for _ in range(2)]  # the update's capture, then both replayed
    n_grad = algo.rollout_grad_steps(PPO_E * DP_PPO_T, PPO_REPEAT, PPO_BATCH)
    expect = {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": DP_PPO_CALLS * DP_PPO_T}
    if differ or int(md["ts"].step) != DP_PPO_CALLS * n_grad:
        raise AssertionError(f"dp_ppo_halfcheetah: {differ} of {len(pairs)} tensors differ from the trainer's programs, "
                             f"step {int(md['ts'].step)}")
    if launches != expect:
        raise AssertionError(f"dp_ppo_halfcheetah: launches {launches}, expected {expect}")
    return launches, [
        f"dp_ppo_halfcheetah: make_dp_train_step at world size 1 on NCCL, NormObs(HalfCheetah) E={PPO_E}, "
        f"{DP_PPO_CALLS} rollouts of T={DP_PPO_T} each with {n_grad} minibatch steps ({PPO_REPEAT} passes of batch "
        f"{PPO_BATCH}): {len(pairs)} tensors (stats, weights, Adam, return and normalization statistics, collect state, "
        f"generator) bit-identical to OnPolicyTrainer's collect_chunk and update_rollout; physics_fused "
        f"{launches['physics_fused']} = 1 per vector step",
        f"dp_ppo_halfcheetah: wall per rollout and update: the mesh step, eager, {md['walls'][0]:.1f} / "
        f"{md['walls'][1]:.1f} ms; the trainer's programs {tr['walls'][0]:.1f} (eager warm-up) / {tr['walls'][1]:.1f} "
        f"(collect captured, update rebuilt for the captured rollout) / {replay_ms[0]:.1f} (update captured) / "
        f"{replay_ms[1]:.1f} ms (both replayed)",
    ]


def dp_trpo_halfcheetah_phase(torch):
    """Phase 54: ``make_dp_train_step`` at world size 1 on NCCL over TRPO on ``NormObs(HalfCheetah())`` at the
    trust-region path's configuration (``build_trust_region``: E = ``TR_E``, T = ``TR_T``, one minibatch of the
    rollout's rows, ``TR_CRITIC_ITERS`` critic steps, ten conjugate-gradient iterations and the line search). From one
    state and generator state, deep copies run ``DP_TR_CALLS`` rollouts with their updates through
    ``OnPolicyTrainer``'s ``collect_chunk`` and ``update_rollout`` programs and through the mesh step, eagerly (its
    gradient, Fisher products and line search averaged over the one rank): every state tensor, the stats and the
    generator bit-identical, and ``physics_fused`` exactly once per vector step of the mesh step. Returns ({kernel:
    launches}, lines)."""
    import copy

    from tianshou_tpu_torch.parallel.mesh import make_dp_train_step
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    algo, ts, coll = build_trust_region(torch, "trpo", TR_E)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    sides = {}
    for side in ("trainer", "mesh"):
        s_ts, s_cs = copy.deepcopy((ts, cstate))
        s_gen = torch.Generator(device="cuda")
        s_gen.set_state(gen.get_state())
        sides[side] = dict(ts=s_ts, cstate=s_cs, gen=s_gen, walls=[], stats=[])
    del ts, cstate
    tr, md = sides["trainer"], sides["mesh"]
    trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(
        batch_size=TR_BATCH, collection_step_num_env_steps=TR_T, update_step_num_repetitions=1, verbose=False))

    def trainer_call():
        out = trainer.collect_chunk(tr["ts"], tr["cstate"], None, tr["gen"], TR_T, keep_rollout=True)
        return trainer.update_rollout(tr["ts"], out.rollout, tr["gen"])

    for _ in range(DP_TR_CALLS):
        stats, ms = _time_call(torch, trainer_call)
        tr["walls"].append(ms)
        tr["stats"].append(stats.map(torch.clone))
    mesh = _mesh_of_one(torch)
    step = make_dp_train_step(algo, coll, mesh, TR_T, 1, TR_BATCH)
    _zero_launches()
    for _ in range(DP_TR_CALLS):
        out, ms = _time_call(torch, lambda: step(md["ts"], md["cstate"], md["gen"]))
        md["walls"].append(ms)
        md["stats"].append(out[2].map(torch.clone))
    launches = _read_launches()
    _group_down()
    pairs = [(x[k], y[k]) for x, y in zip(tr["stats"], md["stats"]) for k in x.keys()]
    pairs += list(zip(_onpolicy_tensors(torch, tr["ts"], tr["cstate"]), _onpolicy_tensors(torch, md["ts"], md["cstate"])))
    pairs += [(tr["gen"].get_state(), md["gen"].get_state())]
    differ = _differing(torch, pairs)
    replay_ms = [_time_call(torch, trainer_call)[1] for _ in range(2)]  # the update's capture, then both replayed
    expect = {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": DP_TR_CALLS * TR_T}
    if differ or int(md["ts"].step) != DP_TR_CALLS:
        raise AssertionError(f"dp_trpo_halfcheetah: {differ} of {len(pairs)} tensors differ from the trainer's "
                             f"programs, step {int(md['ts'].step)}")
    if launches != expect:
        raise AssertionError(f"dp_trpo_halfcheetah: launches {launches}, expected {expect}")
    accepted = [float(s.accepted) for s in md["stats"]]
    return launches, [
        f"dp_trpo_halfcheetah: make_dp_train_step at world size 1 on NCCL, TRPO on NormObs(HalfCheetah) E={TR_E}, "
        f"{DP_TR_CALLS} rollouts of T={TR_T} each with one update of {TR_E * TR_T} rows ({algo.cg_iters} conjugate-"
        f"gradient iterations, {algo.max_backtracks} line-search candidates, {TR_CRITIC_ITERS} critic steps; accepted "
        f"{accepted}): {len(pairs)} tensors (stats, weights, Adam, normalization statistics, collect state, generator) "
        f"bit-identical to OnPolicyTrainer's collect_chunk and update_rollout; physics_fused {launches['physics_fused']} "
        f"= 1 per vector step",
        f"dp_trpo_halfcheetah: wall per rollout and update: the mesh step, eager, {md['walls'][0]:.1f} / "
        f"{md['walls'][1]:.1f} ms; the trainer's programs {tr['walls'][0]:.1f} (eager warm-up) / {tr['walls'][1]:.1f} "
        f"(collect captured, update rebuilt for the captured rollout) / {replay_ms[0]:.1f} (update captured) / "
        f"{replay_ms[1]:.1f} ms (both replayed)",
    ]


def dp_sac_halfcheetah_phase(torch):
    """Phase 55: ``make_dp_offpolicy_train_step`` at world size 1 on NCCL over SAC on HalfCheetah at the off-policy
    path's widths (``examples/mujoco/mujoco_sac.py``: ``OFF_E`` envs, T = ``OFF_T``, one update per env step, batch
    ``OFF_BATCH``, 256x256 nets, alpha 0.2, the ``OFF_BUFFER``-row replay). From one state after a random prefill of
    ``DP_SAC_PREFILL`` steps, deep copies run ``DP_SAC_CHUNKS`` chunks through ``OffPolicyTrainer.megastep`` (eager
    warm-up, then capture and replay) and through the mesh step, eagerly: every weight, target, Adam state, the rings,
    the collect state, the stats and the generator bit-identical, which at world size 1 shows that the target and actor
    noise drawn by the global-draw rule is the one-process draw; ``physics_fused`` exactly once per vector step of the
    mesh step. Returns ({kernel: launches}, lines)."""
    import copy

    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.parallel.mesh import make_dp_offpolicy_train_step
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    torch.manual_seed(SEED)
    env = make("HalfCheetah")
    algo = make_offpolicy(torch, "sac", env, OFF_HID, **OFF_ALGOS["sac"])
    ts = algo.init("cuda")
    buffer, bs = offpolicy_buffer(torch, env, OFF_BUFFER, OFF_E)
    coll = DeviceCollector(VectorDeviceEnv(env, OFF_E, device="cuda"), algo, buffer)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cstate = coll.reset(gen)
    coll.collect(ts, cstate, bs, gen, DP_SAC_PREFILL, random=True)
    n_updates = OFF_T * OFF_E  # one update per env step
    sides = {}
    for side in ("trainer", "mesh"):
        s_ts, s_bs, s_cs = copy.deepcopy((ts, bs, cstate))
        s_gen = torch.Generator(device="cuda")
        s_gen.set_state(gen.get_state())
        sides[side] = dict(ts=s_ts, bs=s_bs, cstate=s_cs, gen=s_gen, walls=[], stats=[])
    del ts, bs, cstate
    tr, md = sides["trainer"], sides["mesh"]
    trainer = OffPolicyTrainer(algo, coll, None, buffer, OffPolicyTrainerParams(
        batch_size=OFF_BATCH, collection_step_num_env_steps=OFF_T, fused_megastep=True, verbose=False))
    for _ in range(DP_SAC_CHUNKS):
        (_, burst), ms = _time_call(torch, lambda: trainer.megastep(tr["ts"], tr["cstate"], tr["bs"], tr["gen"], OFF_T,
                                                                   n_updates))
        tr["walls"].append(ms)
        tr["stats"].append(burst.map(torch.clone))
    mesh = _mesh_of_one(torch)
    step = make_dp_offpolicy_train_step(algo, coll, buffer, mesh, OFF_T, n_updates, OFF_BATCH)
    _zero_launches()
    for _ in range(DP_SAC_CHUNKS):
        out, ms = _time_call(torch, lambda: step(md["ts"], md["cstate"], md["bs"], md["gen"]))
        md["walls"].append(ms)
        md["stats"].append(out[4].map(torch.clone))
    launches = _read_launches()
    _group_down()
    pairs = [(x[k], y[k]) for x, y in zip(tr["stats"], md["stats"]) for k in x.keys()]
    pairs += list(zip(_offpolicy_state_tensors(tr["ts"], tr["bs"], tr["cstate"]),
                      _offpolicy_state_tensors(md["ts"], md["bs"], md["cstate"])))
    pairs += [(tr["gen"].get_state(), md["gen"].get_state())]
    differ = _differing(torch, pairs)
    updates = DP_SAC_CHUNKS * n_updates
    _, replay_ms = _time_call(torch, lambda: trainer.megastep(tr["ts"], tr["cstate"], tr["bs"], tr["gen"], OFF_T,
                                                              n_updates))
    expect = {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": DP_SAC_CHUNKS * OFF_T}
    if differ or int(md["ts"].step) != updates:
        raise AssertionError(f"dp_sac_halfcheetah: {differ} of {len(pairs)} tensors differ from "
                             f"OffPolicyTrainer.megastep, step {int(md['ts'].step)} of {updates}")
    if launches != expect:
        raise AssertionError(f"dp_sac_halfcheetah: launches {launches}, expected {expect}")
    return launches, [
        f"dp_sac_halfcheetah: make_dp_offpolicy_train_step at world size 1 on NCCL, SAC on HalfCheetah E={OFF_E}, nets "
        f"{OFF_HID}, a {OFF_BUFFER}-row replay, {DP_SAC_CHUNKS} chunks of T={OFF_T} and {n_updates} updates of batch "
        f"{OFF_BATCH}: {len(pairs)} tensors (stats, weights, targets, Adam, counters, rings, collect state, generator) "
        f"bit-identical to OffPolicyTrainer.megastep; physics_fused {launches['physics_fused']} = 1 per vector step",
        f"dp_sac_halfcheetah: wall per chunk: the mesh step, eager, {md['walls'][0]:.1f} / {md['walls'][1]:.1f} ms; the "
        f"trainer's megastep {tr['walls'][0]:.1f} (eager warm-up) / {tr['walls'][1]:.1f} (capture and replay) / "
        f"{replay_ms:.1f} ms (replay)",
    ]


def _seeded_builder(seed: int, env_factory=_cartpole):
    """``hl_dqn_cartpole_per``'s experiment builder at ``seed`` (module-level factories: the pool pickles it)."""
    from tianshou_tpu_torch.highlevel.config import ExperimentConfig, OffPolicyTrainingConfig
    from tianshou_tpu_torch.highlevel.experiment import DQNExperimentBuilder

    training = OffPolicyTrainingConfig(max_epochs=1, epoch_num_steps=400, buffer_size=2000, num_train_envs=4,
                                       num_test_envs=4, start_timesteps=100, test_step_num_episodes=2, batch_size=32)
    return (DQNExperimentBuilder(env_factory, ExperimentConfig(seed=seed, persistence_enabled=False), training)
            .with_dqn_params(eps_training=0.3).with_buffer_factory(_per_buffer))


def _broken_env():
    raise RuntimeError("an env factory made to fail")


def _run_summary(torch, result) -> tuple:
    """A run's best reward, env steps, gradient steps and trained weights (on the host)."""
    return (result.best_reward, result.env_step, result.gradient_step,
            [p.detach().cpu() for p in result.train_state.model.parameters()])


def seeded_eval_phase(torch):
    """Phase 53: ``run_seeded_experiments`` over seeds ``SEEDED`` of ``hl_dqn_cartpole_per``'s builder on the card
    (one descent per update, one tree update per update and per vector step), then ``PoolExpLauncher(max_workers=2)``
    under ``spawn`` with the same two experiments and one whose env factory raises: each seed's best reward, env and
    gradient steps and trained weights equal to the sequential run's (bit for bit), the two seeds' weights different,
    the failing one in ``failures`` with its traceback; then ``eval_results`` over the scores.
    The launch counts are the sequential runs' (the pool's run in its own processes). Returns ({kernel: launches},
    lines)."""
    from tianshou_tpu_torch.evaluation.launcher import PoolExpLauncher, run_seeded_experiments
    from tianshou_tpu_torch.evaluation.rliable_evaluation import eval_results

    _zero_launches()
    seq, seq_ms = _time_call(torch, lambda: run_seeded_experiments(_seeded_builder, SEEDED, "seeded_eval", device=DEV))
    launches = _read_launches()
    if seq.failures or len(seq.successes) != len(SEEDED):
        raise AssertionError(f"seeded_eval: sequential failures {seq.failures}")
    results = [r for _, r in seq.successes]
    n_train = _seeded_builder(0)._training.num_train_envs
    grads = sum(r.gradient_step for r in results)
    expect = {"gather_rows": 0, "prefix_sum_idx": grads,
              "tree_update": grads + sum(r.env_step // n_train for r in results), "physics_fused": 0}
    if launches != expect or grads == 0:
        raise AssertionError(f"seeded_eval: launches {launches}, expected {expect}")
    exps = [(_seeded_builder(s).build(), name) for s, (name, _) in zip(SEEDED, seq.successes)]
    broken = (_seeded_builder(SEEDED[0], _broken_env).build(), "seeded_eval/broken")
    pool, pool_ms = _time_call(torch, lambda: PoolExpLauncher(max_workers=2, device=DEV).launch(exps + [broken]))
    got = {name: _run_summary(torch, r) for name, r in pool.successes}
    want = {name: _run_summary(torch, r) for name, r in seq.successes}
    if got.keys() != want.keys() or any(got[n][:3] != want[n][:3] or _differing(torch, zip(got[n][3], want[n][3]))
                                        for n in want):
        raise AssertionError(f"seeded_eval: the pool's runs {({n: g[:3] for n, g in got.items()})} differ from the "
                             f"sequential runs' {({n: w[:3] for n, w in want.items()})} (best reward, env steps, "
                             "gradient steps, weights)")
    first, second = want.values()
    if not _differing(torch, zip(first[3], second[3])):
        raise AssertionError("seeded_eval: seeds 0 and 1 trained to the same weights")
    if [n for n, _ in pool.failures] != ["seeded_eval/broken"] or "made to fail" not in pool.failures[0][1]:
        raise AssertionError(f"seeded_eval: pool failures {[n for n, _ in pool.failures]}")
    summary = eval_results(np.array([r.best_reward for r in results]))
    return launches, [
        f"seeded_eval: run_seeded_experiments over seeds {list(SEEDED)} of hl_dqn_cartpole_per's builder in "
        f"{seq_ms / 1e3:.2f} s: best rewards {[r.best_reward for r in results]}, {grads} updates; launches {launches}",
        f"seeded_eval: PoolExpLauncher(max_workers=2) under spawn, the same seeds and one experiment made to fail, in "
        f"{pool_ms / 1e3:.2f} s: best rewards, env and gradient steps and {len(first[3])} weight tensors a seed "
        f"bit-identical to the sequential runs', the seeds' weights different; the failing one reported "
        f"({pool.failures[0][1].strip().splitlines()[-1]}); eval_results: IQM {summary.iqm:.2f}, mean {summary.mean:.2f}, "
        f"median {summary.median:.2f}, 95% CI [{summary.ci_low:.2f}, {summary.ci_high:.2f}] over {summary.n_runs} runs",
    ]


def bs_example(torch, env):
    """A one-row transition of ``env``'s shapes, for ``offpolicy_graph_check``."""
    from tianshou_tpu_torch.env.core import Discrete

    act = torch.tensor(0) if isinstance(env.action_space, Discrete) else torch.zeros(env.action_space.shape)
    return _vector_example(torch, torch.zeros(env.observation_space.shape), act)


# ---------------------------------------------------------------------------
# the example entry points (examples_torch/), through their own main
# ---------------------------------------------------------------------------
# Each script runs at its defaults but for the depth cut: its options where it takes them, else its ``train``'s
# keywords (functools.partial), a helper of its module bound to smaller sizes, or its trainers' parameters set at
# construction (``_Recording``'s cut). The first four: examples_torch/atari/atari_rainbow.py on the catch game, one
# epoch of EX_RAINBOW_EPOCH steps after a prefill of EX_RAINBOW_PREFILL (from 20 epochs of 20,000 after 2,000);
# examples_torch/mujoco/mujoco_sac.py, one of EX_SAC_EPOCH after EX_SAC_PREFILL (from 50 epochs of 20,000 after
# 10,000); examples_torch/vizdoom/vizdoom_{c51,ppo}.py on SyntheticDoom, one epoch of EX_DOOM_C51_EPOCH steps after a
# prefill of EX_DOOM_C51_PREFILL (from 20 epochs of 20,000 after 2,000; the prefill through ``train``) and one of
# EX_DOOM_PPO_EPOCH, two collects of 2,048 steps (from 20 epochs of 20,000). Then one script per runner route that
# those four do not drive: atari_sac.py (uniform pixel replay, discrete SAC) and atari_ppo.py (run_onpolicy, one
# rollout of 16 x 128 steps, 4 passes of batch 32) on the catch game; mujoco_trpo.py (mujoco/_runner.py:run_onpolicy,
# one natural-gradient update of 16 x 64 steps) and mujoco_td3.py (run_offpolicy) on HalfCheetah; mujoco_ppo_hl.py
# (the Experiment API) over EX_HL_ENVS envs, one rollout of EX_HL_T steps a env (from 64 envs, rollouts of 2,048
# steps a env and 10 epochs of 20,000; the rollout through onpolicy_training_config): 10 passes of batch 64 over its
# 8,192 rows are 1,280 minibatch steps, past OnPolicyTrainer.STEP_GRAPHS_ABOVE, so step graphs;
# ddpg_her_goalreach.py (the HER ring), discrete_cql_cartpole.py (offline/_gather.py, then OfflineTrainer),
# dqn_cartpole.py with --logdir (the TensorBoard logger), and four that build their own: tictactoe_selfplay.py
# (selfplay's prefill, rounds and evaluation cut), psrl.py, irl_gail.py and acrobot_dualdqn.py.
EX_RAINBOW_PREFILL, EX_RAINBOW_EPOCH, EX_SAC_PREFILL, EX_SAC_EPOCH = 400, 2_000, 256, 1_024
EX_DOOM_C51_PREFILL, EX_DOOM_C51_EPOCH, EX_DOOM_PPO_EPOCH = 512, 3_000, 4_096
EX_HL_ENVS, EX_HL_T = 16, 512


class ExRun(NamedTuple):
    """One script's run in the ``examples`` phase: its module, its arguments after ``--device cuda``, the depth cut
    where its options do not reach (``partials``: ``{attr of the module: keywords}``; ``trainer``: trainer parameters
    set at construction), and the kernel launches expected (``launches``: ``rainbow``, 2 ``gather_rows`` per update
    and the sum tree's; ``gather``, 2 ``gather_rows`` per update and nothing else; ``physics``, one ``physics_fused``
    per train and test vector step and nothing else; ``none``)."""

    module: str
    argv: list[str]
    launches: str = "none"
    partials: dict = {}
    trainer: dict = {}


def _ex_atari(script: str, argv: list[str], launches: str = "none") -> ExRun:
    return ExRun(f"examples_torch.atari.{script}", ["--epochs", "1", *argv], launches)


EX_SCRIPTS = {
    "examples_rainbow": _ex_atari("atari_rainbow", ["--epoch-num-steps", str(EX_RAINBOW_EPOCH), "--start-steps",
                                                    str(EX_RAINBOW_PREFILL)], "rainbow"),
    "examples_sac": ExRun("examples_torch.mujoco.mujoco_sac",
                          ["--task", "HalfCheetah", "--epochs", "1", "--epoch-num-steps", str(EX_SAC_EPOCH),
                           "--start-steps", str(EX_SAC_PREFILL)], "physics"),
    "examples_doom_c51": ExRun("examples_torch.vizdoom.vizdoom_c51", ["--epochs", "1", "--epoch-num-steps",
                                                                       str(EX_DOOM_C51_EPOCH)], "gather",
                               {"train": {"start_steps": EX_DOOM_C51_PREFILL}}),
    "examples_doom_ppo": ExRun("examples_torch.vizdoom.vizdoom_ppo", ["--epochs", "1", "--epoch-num-steps",
                                                                       str(EX_DOOM_PPO_EPOCH)]),
    "examples_atari_sac": _ex_atari("atari_sac", ["--epoch-num-steps", "500", "--start-steps", "256"], "gather"),
    "examples_atari_ppo": _ex_atari("atari_ppo", ["--epoch-num-steps", "2048"]),
    "examples_trpo": ExRun("examples_torch.mujoco.mujoco_trpo",
                           ["--task", "HalfCheetah", "--epochs", "1", "--epoch-num-steps", "1024"], "physics"),
    "examples_td3": ExRun("examples_torch.mujoco.mujoco_td3", ["--task", "HalfCheetah", "--epochs", "1",
                                                               "--epoch-num-steps", "128", "--start-steps", "128"],
                          "physics"),
    "examples_ppo_hl": ExRun("examples_torch.mujoco.mujoco_ppo_hl",
                             ["--epochs", "1", "--num-envs", str(EX_HL_ENVS), "--epoch-num-steps",
                              str(EX_HL_T * EX_HL_ENVS)], "physics",
                             {"onpolicy_training_config": {"collection_step_num_env_steps": EX_HL_T}}),
    "examples_her_goalreach": ExRun("examples_torch.continuous.ddpg_her_goalreach", [],
                                    trainer=dict(max_epochs=1, epoch_num_steps=2_000, start_steps=1_000)),
    "examples_cql_cartpole": ExRun("examples_torch.offline.discrete_cql_cartpole", [],
                                   partials={"gather_cartpole": {"dataset_size": 1_000}},
                                   trainer=dict(max_epochs=1, epoch_num_steps=400, start_steps=200,
                                                update_step_num_gradient_steps_per_epoch=100)),
    # a trailing --logdir gets a temporary directory, removed after the run
    "examples_dqn_cartpole_logger": ExRun("examples_torch.discrete.dqn_cartpole", ["--epochs", "1", "--logdir"],
                                          trainer=dict(epoch_num_steps=1_000)),
    "examples_selfplay": ExRun("examples_torch.marl.tictactoe_selfplay", [],
                               partials={"selfplay": {"prefill": 500, "rounds": 20, "eval_episodes": 20}}),
    "examples_psrl": ExRun("examples_torch.modelbased.psrl", ["--epochs", "1"]),
    "examples_gail": ExRun("examples_torch.inverse.irl_gail", [], partials={"gather_pendulum": {"dataset_size": 1_000}},
                           trainer=dict(max_epochs=1, epoch_num_steps=512, start_steps=256)),
    "examples_acrobot": ExRun("examples_torch.box2d.acrobot_dualdqn", ["--epochs", "1", "--epoch-num-steps", "400"]),
}


def _doom_checks(torch, res) -> str:
    """The ViZDoom scripts' two extra checks: one ``gather_rows`` call on the C51 run's own ring (``[100000, 2400]``
    bytes, 256 rows) bit-exact against ``src[idx]``; ``SyntheticDoom._obs`` on the card over every heading x target
    x dist in [0, 30], bit-equal to the same call on the CPU. Their launches are not the path's."""
    from examples_torch.vizdoom.env import SyntheticDoom, _DoomState
    from tianshou_tpu_torch.ops.kernels import gather

    ring = res.buf_state.data["obs"]  # [16, 6250, 40, 60, 1]
    src = ring.reshape(ring.shape[0] * ring.shape[1], -1)
    if tuple(src.shape) != (DOOM_RING, DOOM_ROW):
        raise AssertionError(f"the ViZDoom ring is {tuple(src.shape)}, expected {(DOOM_RING, DOOM_ROW)}")
    idx = torch.randint(0, DOOM_RING, (DOOM_ROWS,), device=DEV, generator=torch.Generator(device=DEV).manual_seed(SEED))
    if not torch.equal(gather.gather_rows(src, idx), src[idx]):
        raise AssertionError("gather_rows on the ViZDoom ring differs from src[idx]")
    n = SyntheticDoom.n_headings
    grid = torch.stack(torch.meshgrid(torch.arange(n), torch.arange(n), torch.arange(31), indexing="ij")).reshape(3, -1)
    states = [_DoomState(*grid.to(device=dev, dtype=torch.int32), torch.zeros(grid.shape[1], dtype=torch.int32,
                                                                              device=dev)) for dev in (DEV, "cpu")]
    card, cpu = (SyntheticDoom()._obs(s) for s in states)
    if not torch.equal(card.cpu(), cpu):
        raise AssertionError("SyntheticDoom._obs on the card differs from the CPU's")
    lit = int(src.count_nonzero())
    return (f"gather_rows on the run's ring uint8[{DOOM_RING},{DOOM_ROW}] x {DOOM_ROWS} rows bit-exact against "
            f"src[idx] ({lit} lit bytes in the ring); SyntheticDoom._obs on the card bit-equal to the CPU's over "
            f"{grid.shape[1]} states")


def _ex_weights(torch, res) -> list:
    """The float tensors of a script's train states (a trainer's result's, or self-play's ``(stats, states)``): the
    nets' parameters and buffers, and the tensors a state keeps beside them (PSRL's posterior, which has no net)."""
    states = res[1].values() if isinstance(res, tuple) else [res.train_state]
    tensors = [t for ts in states for t in (*ts.model.state_dict().values(), *ts.extra.values())]
    return [t for t in tensors if t.is_floating_point()]


def examples_phase(torch, smi: str = "") -> tuple[dict, list[str]]:
    """Phase 56: port scripts through their own ``main([...])`` on the card (``EX_SCRIPTS``), their output printed as
    it comes. Counters are zeroed just before and read just after each ``main``, and must equal what the run's
    ``ExRun.launches`` says for its updates and vector steps: ``atari_rainbow.py`` (the catch game, a prioritized
    uint8 replay of 100,000 frames over 16 envs, noisy dueling C51) ``gather_rows`` 2 and ``prefix_sum_idx`` 1 per
    update, ``tree_update`` 1 per update and 1 per collect step (prefill included), and a tree that ``_check_tree``
    passes; ``mujoco_sac.py``, ``mujoco_trpo.py``, ``mujoco_td3.py`` and ``mujoco_ppo_hl.py`` (HalfCheetah)
    ``physics_fused`` once per vector step, prefill and test phase included, and nothing else; ``vizdoom_c51.py``
    (SyntheticDoom, a uint8 replay of 100,000 frames of 40x60) and ``atari_sac.py`` (a uniform uint8 replay)
    ``gather_rows`` 2 per update and nothing else, then :func:`_doom_checks` on the doom run; every other script no
    kernel. Each must end with one finite test phase per trainer it builds (self-play: finite returns of its
    evaluation against the random policy) and finite weights on the card; ``mujoco_ppo_hl.py``'s update must run as
    step graphs, ``dqn_cartpole.py --logdir`` must write its TensorBoard events. Returns
    ({name: {kernel: launches}}, lines)."""
    import functools
    import importlib
    import shutil

    by_name, lines = {}, []
    for name, run in EX_SCRIPTS.items():
        script = importlib.import_module(run.module)
        saved = {attr: getattr(script, attr) for attr in run.partials}
        argv = list(run.argv)
        logdir = tempfile.mkdtemp(prefix="tt_examples_") if argv[-1:] == ["--logdir"] else None
        if logdir is not None:
            argv.append(logdir)
        for attr, keywords in run.partials.items():
            setattr(script, attr, functools.partial(saved[attr], **keywords))
        t0 = time.perf_counter()
        try:
            with _Recording(run.trainer) as rec:
                _zero_launches()
                res = script.main(["--device", DEV, *argv])
                launches = _read_launches()
            wall = time.perf_counter() - t0
            events = sum(1 for _ in Path(logdir).rglob("events.out.tfevents.*")) if logdir else 0
        finally:
            for attr, fn in saved.items():
                setattr(script, attr, fn)
            if logdir is not None:
                shutil.rmtree(logdir, ignore_errors=True)
        params = _ex_weights(torch, res)
        if not params or not all(p.device.type == torch.device(DEV).type and bool(torch.isfinite(p).all())
                                 for p in params):
            raise AssertionError(f"{name}: a weight is off the card or not finite")
        none = {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": 0}
        if isinstance(res, tuple):  # self-play: no trainer, the evaluation's collect stats
            stats = res[0]
            if rec.trainers or len(stats.returns) != run.partials["selfplay"]["eval_episodes"] or not np.isfinite(
                    stats.returns).all() or launches != none:
                raise AssertionError(f"{name}: {len(stats.returns)} evaluation returns, launches {launches}")
            by_name[name] = launches
            n_upd = sum(int(ts.step) for ts in res[1].values())
            lines.append(f"{name}: {run.module}.main({argv}) with {run.partials} in {wall:.1f} s: {n_upd} updates "
                         f"of the two agents, win rate vs random {float((stats.returns > 0).mean()):.2f} over "
                         f"{len(stats.returns)} games; launches {launches} [{smi}]")
            continue
        trainer = rec.trainers[-1]
        if len(rec.tests) != len(rec.trainers) or not all(np.isfinite(t.returns).all() and len(t.returns)
                                                          for t in rec.tests) or not np.isfinite(res.best_reward):
            raise AssertionError(f"{name}: test phases {[s.returns for s in rec.tests]} of {len(rec.trainers)} "
                                 f"trainers, best {res.best_reward}")
        envs = trainer.train_collector.venv.num_envs if trainer.train_collector is not None else 0
        vector_steps = res.env_step // envs if envs else 0
        n_upd = res.gradient_step
        test_steps = rec.tests[-1].n_collected_steps // trainer.test_collector.venv.num_envs
        detail = f"{vector_steps} train vector steps of {envs} envs, {n_upd} gradient steps"
        if run.launches == "rainbow":
            expect = {"gather_rows": 2 * n_upd, "prefix_sum_idx": n_upd, "tree_update": n_upd + vector_steps,
                      "physics_fused": 0}
            detail = _check_tree(torch, trainer.buffer, res.buf_state, torch.Generator(device=DEV).manual_seed(SEED),
                                 trainer.params.batch_size)
        elif run.launches == "physics":
            expect = {**none, "physics_fused": vector_steps + test_steps}
            detail = f"{vector_steps} train and {test_steps} test vector steps, {n_upd} gradient steps"
        elif run.launches == "gather":
            expect = {**none, "gather_rows": 2 * n_upd}
            if name == "examples_doom_c51" and launches == expect:
                detail = _doom_checks(torch, res)
        else:
            expect = dict(none)
        if launches != expect or n_upd == 0:
            raise AssertionError(f"{name}: kernel launches {launches} for {n_upd} updates and {vector_steps} vector "
                                 f"steps, expected {expect}")
        if name == "examples_ppo_hl":
            graphs = trainer.step_graphs
            if graphs is None or graphs.replays == 0:
                raise AssertionError(f"{name}: the rollout update ran no step graph")
            detail += f"; the update as step graphs: {graphs.captures} captures, {graphs.replays} replays"
        if logdir is not None:
            if events == 0:
                raise AssertionError(f"{name}: the logger wrote no event file under --logdir")
            detail += f"; {events} TensorBoard event file(s) under --logdir"
        if len(rec.trainers) > 1:
            detail += f"; trainers {[type(t).__name__ for t in rec.trainers]}"
        by_name[name] = launches
        cut = "".join(f" with {attr}{kw}" for attr, kw in run.partials.items())
        cut += f" with trainer params {run.trainer}" if run.trainer else ""
        lines.append(f"{name}: {run.module}.main({argv}){cut} in {wall:.1f} s: best_reward {res.best_reward:.2f}, "
                     f"env_steps {res.env_step}, updates {n_upd}, test returns mean "
                     f"{float(np.mean(rec.tests[-1].returns)):.2f}; launches {launches}; {detail} [{smi}]")
    return by_name, lines


# ---------------------------------------------------------------------------
# the benchmark scripts of examples_torch/benchmark/ (phases 59-62)
# ---------------------------------------------------------------------------
# seed_vmap_sac_halfcheetah: seed_vmap.py's run_multiseed("sac", "HalfCheetah", SV_SEEDS) at its widths (32 envs a seed,
# 256x256 nets, batch 256, T 4, one update per env step, a 1 M-row ring a seed, 10 test envs a seed over the 1,000-step
# horizon), the random prefill cut from 10,000 steps a seed to SV_PREFILL and the epochs from 50 of 20,000 steps to one
# of SV_EPOCH; then the one-seed run of SV_SEEDS[1] at the same depth
SV_SEEDS, SV_PREFILL, SV_EPOCH, SV_REPLAYS = (0, 1, 2), 512, 1_024, 2
BT_ITERS = 3        # benchmark_throughput: throughput.py's timed megasteps, cut from 10
BO_CHUNKS = 4       # benchmark_offpolicy: offpolicy_throughput.py's timed run, cut from 40 chunks
BH_ENVS, BH_STEPS, BH_ENV_MS = 8, 2_000, 2.0  # benchmark_host: host_throughput.py's envs and step cost, its 4,000 steps
                                              # cut to 2,000


def seed_vmap_phase(torch, smi: str) -> tuple[dict, dict, dict, list[str]]:
    """Phase 59, ``seed_vmap_sac_halfcheetah``: ``examples_torch/benchmark/seed_vmap.py``'s ``run_multiseed`` over
    ``SV_SEEDS`` (the seeds stacked on the env axis), then over ``SV_SEEDS[1]`` alone, at the same depth. Counters
    zeroed just before and read just after each run: exactly one ``physics_fused`` launch per vector step (prefill,
    megasteps, test) and nothing else, and every physics step the runs' Python took over ``S x 32`` train rows or
    ``S x 10`` test rows; the megastep program called once per megastep, its first call eager and each later one one
    graph replay; lane 1's saved train state (weights, targets, every optimizer tensor, the step) and its curve
    bit-equal to the one-seed run's. Then each run's megastep replayed alone (``SV_REPLAYS``), and ``physics_fused``
    timed on the stacked run's state: one launch over all 96 rows against three launches over each seed's 32 (a graph
    of 20 calls, median of 60), the rows bit-equal, beside the bound of the 96 rows' active rows. Returns ({kernel:
    launches} of the stacked run, the same of the one-seed run, the kernel's record, lines)."""
    from examples_torch.benchmark import seed_vmap
    from tianshou_tpu_torch.env.mujoco import base
    from tianshou_tpu_torch.env.physics import dynamics
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    rows, stacks = [], []
    step = base.fused_step

    def counted(model, q, *args, **kwargs):  # the runs' Python: eager calls and captures, never a replay
        rows.append(int(q.shape[0]))
        return step(model, q, *args, **kwargs)

    class Kept(seed_vmap.SeedStack):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            stacks.append(self)

    saved = (base.fused_step, seed_vmap.SeedStack)
    base.fused_step, seed_vmap.SeedStack = counted, Kept
    runs, lines = {}, []
    try:
        with tempfile.TemporaryDirectory(prefix="tt_seed_vmap_") as tmp:
            for seeds in (SV_SEEDS, SV_SEEDS[1:2]):
                rows.clear()
                _zero_launches()
                t0 = time.perf_counter()
                res = seed_vmap.run_multiseed("sac", "HalfCheetah", list(seeds), epochs=1, epoch_num_steps=SV_EPOCH,
                                              start_steps=SV_PREFILL, save_params=f"{tmp}/s{len(seeds)}.pt",
                                              device=DEV)
                wall = time.perf_counter() - t0
                launches = _read_launches()
                payload = torch.load(f"{tmp}/s{len(seeds)}.pt", map_location="cpu")
                runs[len(seeds)] = (res, launches, list(rows), wall, payload, stacks[-1])
    finally:
        base.fused_step, seed_vmap.SeedStack = saved
    for S, (res, launches, seen, wall, payload, stack) in runs.items():
        E_, T_, horizon = stack.num_envs, stack.chunk_len, stack.env.max_episode_steps
        prefill_chunks = -(-SV_PREFILL // (T_ * E_))
        megasteps = -(-SV_EPOCH // (T_ * E_))
        vector_steps = (prefill_chunks + megasteps) * T_ + horizon
        want = {"gather_rows": 0, "prefix_sum_idx": 0, "tree_update": 0, "physics_fused": vector_steps}
        if launches != want:
            raise AssertionError(f"seed_vmap S={S}: launches {launches}, expected {want}")
        if set(seen) != {S * E_, S * stack.test_envs}:
            raise AssertionError(f"seed_vmap S={S}: physics steps over {sorted(set(seen))} rows")
        progs = {g.name: g for g in stack.pool.graphs}
        mega = progs["megastep"]
        if (mega.calls, mega.replays, progs["prefill"].calls) != (megasteps, megasteps - 1, prefill_chunks):
            raise AssertionError(f"seed_vmap S={S}: megastep {mega.calls} calls {mega.replays} replays, prefill "
                                 f"{progs['prefill'].calls} calls")
        if not all(np.isfinite(r["best_reward"]) for r in res) or [int(ts.step) for ts in stack.tss] != [
                megasteps * stack.n_updates] * S:
            raise AssertionError(f"seed_vmap S={S}: results {res}, steps {[int(ts.step) for ts in stack.tss]}")
    (res3, _, _, wall3, pay3, stack3), (res1, _, _, wall1, pay1, stack1) = runs[len(SV_SEEDS)], runs[1]
    got, want = ([x for x in _leaves(p) if isinstance(x, torch.Tensor)] for p in (pay3["tss"][1], pay1["tss"][0]))
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
    if differ or len(got) != len(want) or len(want) < 20 or res3[1]["curve"] != res1[0]["curve"]:
        raise AssertionError(f"seed_vmap: lane 1 differs from the one-seed run of seed {SV_SEEDS[1]}: tensors "
                             f"{differ[:5]} of {len(want)}, curves {res3[1]['curve']} / {res1[0]['curve']}")
    # the megastep replayed alone: steady agent-steps/s of S seeds and of one
    steady = {}
    for S, stack in ((len(SV_SEEDS), stack3), (1, stack1)):
        walls = [_time_call(torch, stack.megastep)[1] for _ in range(SV_REPLAYS)]
        steady[S] = (statistics.median(walls), S * stack.chunk_len * stack.num_envs / statistics.median(walls) * 1e3)
    # physics_fused on the stacked run's state: one launch over every seed's rows against one per seed
    env = stack3.env
    model, fs = env.model, env.frame_skip
    q, qd = stack3.cstate.env_state.q.contiguous(), stack3.cstate.env_state.qd.contiguous()
    n, per = q.shape[0], stack3.num_envs
    ctrl = torch.rand(n, len(model.actuators), device=DEV, generator=torch.Generator(device=DEV).manual_seed(4)) * 2 - 1
    parts = [tuple(x[i * per:(i + 1) * per].contiguous() for x in (q, qd, ctrl)) for i in range(n // per)]
    whole = pf.fused_step(model, q, qd, ctrl, frame_skip=fs)
    apart = [pf.fused_step(model, *p, frame_skip=fs) for p in parts]
    if not all(torch.equal(whole[k], torch.cat([a[k] for a in apart])) for k in (0, 1)):
        raise AssertionError("physics_fused over the stacked rows differs from each seed's rows stepped alone")
    kern, kern_e = _time_ms(lambda: pf.fused_step(model, q, qd, ctrl, frame_skip=fs))
    three = _time_ms(lambda: [pf.fused_step(model, *p, frame_skip=fs) for p in parts])[0]
    n_sub = fs * dynamics.resolve_substeps(model, env.substeps)
    contacts, limits = dynamics.active_rows(model, q)
    flops = physics_flops(model, contacts, limits, n_sub)
    by_ops = flops / H100_FP32_OPS_PER_S * 1e3
    by_bytes = n * (4 * model.nq + len(model.actuators)) * 4 / H100_HBM_BYTES_PER_S * 1e3
    rec = {"rows": n, "ms": kern, "eager_ms": kern_e, "ms_per_seed_launches": three, "launches": len(parts),
           "bound_ms": max(by_ops, by_bytes), "bound_by": "operations" if by_ops >= by_bytes else "bytes",
           "gflop": flops / 1e9}
    mega3 = {g.name: g for g in stack3.pool.graphs}["megastep"]
    lines += [
        f"seed_vmap_sac_halfcheetah: run_multiseed('sac', 'HalfCheetah', {list(SV_SEEDS)}) at {per} envs a seed, T "
        f"{stack3.chunk_len}, {stack3.n_updates} updates a seed per megastep of batch {stack3.batch_size}, prefill "
        f"{SV_PREFILL} and one epoch of {SV_EPOCH} steps a seed, the {env.max_episode_steps}-step test: {wall3:.1f} s; best rewards {[round(r['best_reward'], 2) for r in res3]}; "
        f"launches {runs[len(SV_SEEDS)][1]}, one physics_fused per vector step over {len(SV_SEEDS) * per} rows (train) "
        f"and {len(SV_SEEDS) * stack3.test_envs} (test); megastep: {mega3.calls} calls, {mega3.replays} replays (one "
        f"per megastep after its eager warm-up), capture {mega3.capture_s:.2f} s; {_graph_report(stack3.pool, 1)} "
        f"[{smi}]",
        f"seed_vmap_sac_halfcheetah: one-seed run of seed {SV_SEEDS[1]} at the same depth {wall1:.1f} s; lane 1 "
        f"bit-equal to it ({len(want)} tensors of weights, targets and optimizer state, and the curve "
        f"{res1[0]['curve']}); agent-steps/s over the whole run (warm-up and captures included) "
        f"{res3[0]['agent_steps_per_s']:.1f} at S={len(SV_SEEDS)} against {res1[0]['agent_steps_per_s']:.1f} at S=1; "
        f"a replayed megastep {steady[len(SV_SEEDS)][0]:.2f} ms at S={len(SV_SEEDS)} ({steady[len(SV_SEEDS)][1]:.1f} "
        f"agent-steps/s) against {steady[1][0]:.2f} ms at S=1 ({steady[1][1]:.1f}), ratio "
        f"{steady[len(SV_SEEDS)][1] / steady[1][1]:.3f} [{smi}]",
        f"seed_vmap_sac_halfcheetah: physics_fused on the stacked state, us per vector step: one launch over {n} rows "
        f"{kern * 1e3:.2f} (CUDA graph) {kern_e * 1e3:.2f} (eager) against {len(parts)} launches over {per} rows "
        f"{three * 1e3:.2f}; rows bit-equal; bound {rec['bound_ms'] * 1e3:.3f} us by {rec['bound_by']} ({flops / 1e9:.4f} "
        f"GFLOP), kernel at {rec['bound_ms'] / kern:.4f} of the bound's rate [{smi}]",
    ]
    return runs[len(SV_SEEDS)][1], runs[1][1], rec, lines


def benchmark_throughput_phase(torch, smi: str) -> tuple[dict, list[str]]:
    """Phase 60, ``benchmark_throughput``: ``examples_torch/benchmark/throughput.py`` through its ``main`` (PPO on
    CartPole at each of its numbers of envs, collect and update one graph per megastep), the timed megasteps cut
    from 10 to ``BT_ITERS``; no kernel of the port runs. Returns ({kernel: launches}, lines)."""
    from examples_torch.benchmark import throughput

    saved = throughput.ITERS
    throughput.ITERS = BT_ITERS
    t0 = time.perf_counter()
    try:
        _zero_launches()
        rates = throughput.main(["--device", DEV])
        launches = _read_launches()
    finally:
        throughput.ITERS = saved
    if any(launches.values()) or list(rates) != list(throughput.ENVS) or not all(
            np.isfinite(r) and r > 0 for r in rates.values()):
        raise AssertionError(f"benchmark_throughput: rates {rates}, launches {launches}")
    return launches, [f"benchmark_throughput: throughput.py main (PPO CartPole, T {throughput.T}, repeat "
                      f"{throughput.REPEAT}, batch min({throughput.BATCH}, T*E), {throughput.WARMUP} warm-up and "
                      f"{BT_ITERS} timed megasteps) in {time.perf_counter() - t0:.1f} s: env-steps/s "
                      f"{ {E: round(r, 1) for E, r in rates.items()} }; no kernel [{smi}]"]


def benchmark_offpolicy_phase(torch, smi: str) -> tuple[dict, list[str]]:
    """Phase 61, ``benchmark_offpolicy``: ``examples_torch/benchmark/offpolicy_throughput.py`` through its ``main``
    (DQN on CartPole at E = 1,024, T = 32, batch 1,024, separate collect and update programs, then the fused
    megastep), the timed run cut from 40 chunks to ``BO_CHUNKS``: each mode's timed run exactly ``BO_CHUNKS`` chunks
    of env steps and ``BO_CHUNKS`` x 328 gradient steps; no kernel. Returns ({kernel: launches}, lines)."""
    from examples_torch.benchmark import offpolicy_throughput as op

    saved = op.TIMED_CHUNKS
    op.TIMED_CHUNKS = BO_CHUNKS
    t0 = time.perf_counter()
    try:
        _zero_launches()
        out = op.main(["--device", DEV])
        launches = _read_launches()
    finally:
        op.TIMED_CHUNKS = saved
    n_updates = max(1, round(0.01 * op.T * op.E))
    for fused, run in out.items():
        if (run["env_steps"], run["gradient_steps"]) != (BO_CHUNKS * op.T * op.E, BO_CHUNKS * n_updates):
            raise AssertionError(f"benchmark_offpolicy fused={fused}: {run}")
    if any(launches.values()):
        raise AssertionError(f"benchmark_offpolicy: launches {launches}")
    rates = {f"fused={f}": round(r["env_steps_per_s"], 1) for f, r in out.items()}
    return launches, [f"benchmark_offpolicy: offpolicy_throughput.py main (DQN CartPole E {op.E}, T {op.T}, batch "
                      f"1024, {n_updates} updates a chunk; warm-up {op.WARMUP_CHUNKS} chunks, timed {BO_CHUNKS}) in "
                      f"{time.perf_counter() - t0:.1f} s: env-steps/s {rates}, each timed run "
                      f"{BO_CHUNKS * n_updates} gradient steps; fused against separate "
                      f"{out[True]['env_steps_per_s'] / out[False]['env_steps_per_s']:.3f}; no kernel [{smi}]"]


def benchmark_host_phase(torch, smi: str) -> tuple[dict, list[str]]:
    """Phase 62, ``benchmark_host``: ``examples_torch/benchmark/host_throughput.py``'s ``run`` with its DQN and its
    envs and step cost (``BH_ENVS`` Subproc workers, ``BH_ENV_MS`` ms a step; ``BH_STEPS`` steps), over
    ``NumpyCartPole`` (the card's machine has no ``gymnasium``) in its ``SleepyCartPole``: ``HostCollector`` against
    ``PipelinedHostCollector``. ``host_overlap.py`` (real Gymnasium MuJoCo), ``run_benchmark.py`` and
    ``seed_queue.py`` (subprocesses over scripts the card already runs; a ``"vmap"`` job's body is phase 59) run on
    the CPU only. Returns ({kernel: launches}, lines)."""
    from examples_torch.benchmark import host_throughput as ht
    from examples_torch.common import setup
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.data.pipelined_collector import PipelinedHostCollector
    from tianshou_tpu_torch.env.venvs import SubprocVectorEnv

    dev, _ = setup(DEV, 0)
    algo = ht.make_algo()
    ts = algo.init(dev)
    rates = {}
    t0 = time.perf_counter()
    _zero_launches()
    for name, cls in (("sequential", HostCollector), ("pipelined", PipelinedHostCollector)):
        venv = SubprocVectorEnv([lambda: ht.SleepyCartPole(BH_ENV_MS, NumpyCartPole()) for _ in range(BH_ENVS)],
                                recv_timeout=WAIT_S)
        try:
            rates[name] = ht.run(cls, venv, algo, ts, BH_STEPS, dev)
        finally:
            venv.close()
    launches = _read_launches()
    if any(launches.values()) or not all(r > 0 for r in rates.values()):
        raise AssertionError(f"benchmark_host: rates {rates}, launches {launches}")
    return launches, [
        f"benchmark_host: host_throughput.run over SubprocVectorEnv of {BH_ENVS} SleepyCartPole({BH_ENV_MS} ms, "
        f"NumpyCartPole), {BH_STEPS} steps, in {time.perf_counter() - t0:.1f} s: env-steps/s sequential "
        f"{rates['sequential']:.1f}, pipelined {rates['pipelined']:.1f}, pipelined against sequential "
        f"{rates['pipelined'] / rates['sequential']:.3f}; no kernel [{smi}]",
        "benchmark_host: host_overlap.py runs on the CPU only (real Gymnasium MuJoCo: no gymnasium or mujoco on this "
        "machine); run_benchmark.py and seed_queue.py on the CPU only (subprocesses over scripts this run drives; a "
        "vmap job's body is seed_vmap_sac_halfcheetah)",
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 1
    from tianshou_tpu_torch.ops.kernels import _build, gather, physics_fused, sumtree

    # float32 matmuls and convolutions in full precision (the net computes in bf16)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    smi = _smi()
    print(f"device: {smi} ({torch.cuda.get_device_name(0)})", flush=True)
    t0 = time.perf_counter()
    libs = _build.build()  # every kernel and every model signature, one nvcc each, started together
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(libs)} libraries: {', '.join(lib.name for lib in libs)}", flush=True)
    # what ptxas says of each fused step kernel (registers, static shared memory, per-thread local memory:
    # its stack frame and spills), beside what the library says of its launch (lanes per env, dynamic shared memory)
    from tianshou_tpu_torch.env.mujoco import make
    models = {}  # library file name -> a model it steps
    for task in PHYS_TASKS:
        for contact_model in ("constraint", "penalty"):
            model = make(task).model
            model.contact_model = contact_model
            models[_build._resolve(physics_fused.build_target(model))[1].name] = model
    for lib in libs:
        found = re.search(r"fused_step_kernel\S*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
                          r"\nptxas info\s*: Used (\d+) registers([^\n]*)", _build.build_logs.get(lib.name, ""))
        if found and lib.name in models:
            info = physics_fused.kernel_info(models[lib.name])
            static = re.search(r"(\d+) bytes smem", found[5])
            print(f"build: {lib.name}: TEAM {info['team']} lanes per env, {found[4]} registers, static shared memory "
                  f"{static[1] if static else 0} B, dynamic shared memory {info['shared_bytes_per_env']} B per env x "
                  f"{info['envs_per_block']} envs per block ({info['rows_in_shared']} QP rows in it, "
                  f"{info['scratch_floats_per_env'] * 4} B of global scratch per env for the rest), local memory per thread: "
                  f"{found[1]} B stack frame, {found[2]} B spill stores, {found[3]} B spill loads")

    records = []
    for phase, module in ((gather_phase, gather), (sumtree_phase, sumtree), (physics_phase, physics_fused)):
        t0 = time.perf_counter()
        recs, lines = phase(torch, module)
        names = " and ".join(r["name"] for r in recs)
        print("\n".join(lines), f"\n{names} kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)
        records += recs

    for kind in ("dqn", "rainbow"):
        t0 = time.perf_counter()
        lines = graph_phase(torch, kind)  # raises unless graphs and the eager loop agree
        print("\n".join(lines), f"\n{kind} graph phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    lines = onpolicy_graph_phase(torch)  # raises unless graphs and the eager calls agree
    print("\n".join(lines), f"\non-policy graph phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)

    by_path = {}
    for kind, fused in (("dqn", False), ("rainbow", False), ("dqn", True)):
        t0 = time.perf_counter()
        name = f"{kind}_megastep" if fused else kind
        # raises unless every kernel ran as often as it must
        _, by_path[name], lines = main_path(torch, kind, fused)
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    # bench.py's atari_update_burst: raises unless 2 gathers of 4 x batch rows per update and graph equals eager
    by_path["update_burst_pixels"], lines, burst_gather = update_burst_pixels_path(torch, smi)
    print("\n".join(lines), f"\nupdate_burst_pixels path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for prio in (False, True):
        t0 = time.perf_counter()
        name = "cartpole_per" if prio else "cartpole"
        by_path[name], lines = cartpole_path(torch, prio)  # raises below the threshold
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    lines = determinism_phase(torch)  # raises unless the two traces are equal
    print("\n".join(lines), f"\ndeterminism phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for task, steps in PHYS_PATHS:
        t0 = time.perf_counter()
        by_path[task.lower()], lines = physics_path(torch, task, steps)  # raises unless one launch per step
        print("\n".join(lines), f"\n{task} physics path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    # the penalty branch: raises unless one launch per step
    by_path["physics_penalty_halfcheetah"], lines = physics_path(torch, *PEN_PATH, penalty=True)
    print("\n".join(lines), f"\nphysics_penalty_halfcheetah path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    by_path["humanoid_physics"], lines = humanoid_physics_path(torch)  # raises on a launch or a graph/eager difference
    print("\n".join(lines), f"\nhumanoid_physics path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for task, steps in PPO_PATHS:
        t0 = time.perf_counter()
        name = f"ppo_{task.lower()}"
        by_path[name], lines, _ = ppo_path(torch, task, steps)  # raises unless one launch per vector step
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    # bench.py's mujoco_ppo_16k: raises unless one launch per vector step, and on the kernel's check at that width
    by_path["ppo_halfcheetah_16k"], lines, (coll, cstate) = ppo_path(
        torch, "HalfCheetah", PPO16K_T, PPO16K_E, PPO16K_BATCH, PPO16K_ITERS, name="ppo_halfcheetah_16k")
    at_scale, more = physics_at_scale(torch, coll, cstate, smi)
    del coll, cstate
    print("\n".join(lines + more), f"\nppo_halfcheetah_16k path phase: {time.perf_counter() - t0:.1f} s [{smi}]",
          flush=True)
    for name, path in (("ppo_cartpole", ppo_cartpole_path), ("mujoco_example", mujoco_example_path)):
        t0 = time.perf_counter()
        by_path[name], lines = path(torch)  # raises below the threshold or on a failed check
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for kind in ("td3", "sac", "redq"):
        t0 = time.perf_counter()
        lines = offpolicy_graph_phase(torch, kind)  # raises unless graphs and the eager loop agree
        print("\n".join(lines), f"\ncontinuous graph phase {kind}: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for name in OFF_PATHS:
        t0 = time.perf_counter()
        by_path[name], lines = offpolicy_path(torch, name)  # raises unless one launch per vector step
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for kind, task in (("sac", "Pendulum"), ("td3", "Pendulum"), ("ddpg", "Pendulum"), ("sac", "InvertedPendulum")):
        t0 = time.perf_counter()
        name = f"pendulum_{kind}" if task == "Pendulum" else f"inverted_pendulum_{kind}"
        by_path[name], lines = pendulum_path(torch, kind, task)  # raises below the threshold
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    lines = trust_region_graph_phase(torch)  # raises unless the graphs and the eager calls agree bit for bit
    print("\n".join(lines), f"\ntrust-region and gSDE graph phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    paths = [(name, lambda name=name: trust_region_path(torch, name)) for name in TR_PATHS]
    paths += [("ppo_sde_halfcheetah", lambda: mujoco_example_path(torch, sde=True)),
              ("trpo_cartpole", lambda: trpo_cartpole_path(torch)), ("ppo_mlp_cartpole", lambda: ppo_mlp_cartpole_path(torch))]
    for name, path in paths:
        t0 = time.perf_counter()
        by_path[name], lines = path()  # raises on a failed check, or below the threshold (trpo_cartpole)
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for kind in DIST_KINDS:
        t0 = time.perf_counter()
        lines = graph_phase(torch, kind)  # raises unless graphs and the eager loop agree
        print("\n".join(lines), f"\n{kind} graph phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for kind in DIST_KINDS:
        t0 = time.perf_counter()
        # raises unless the gather kernel ran exactly twice per update
        _, by_path[kind], lines = main_path(torch, kind, chunks=DIST_CHUNKS, steps=DIST_T)
        print("\n".join(lines), f"\n{kind} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for name in DIST_SCORE:
        t0 = time.perf_counter()
        by_path[name], lines = dist_score_path(torch, name)  # raises below the threshold
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    lines = host_ring_identity(torch) + pipelined_check(torch)  # raise unless the rings agree
    print("\n".join(lines), f"\nhost venv and pipelined checks: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    paths = [(f"host_dqn_pixels{'_overlap' if o else ''}", lambda o=o: host_dqn_pixels_path(torch, o)) for o in (False, True)]
    paths += [("host_ppo_cartpole", lambda: host_ppo_cartpole_path(torch)),
              ("recurrent_dqn_pomdp", lambda: recurrent_dqn_pomdp_path(torch))]
    paths += [(f"her_ddpg_goal_reach_n{n}", lambda n=n: her_ddpg_goal_reach_path(torch, n)) for n in (1, 3)]
    paths += [("cached_buffer", lambda: cached_buffer_phase(torch))]
    for name, path in paths:
        t0 = time.perf_counter()
        by_path[name], lines = path()  # raises on a failed check or below the threshold
        print("\n".join(lines), f"\n{name} phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    lines = finite_env_phase(torch)  # raises unless the card's counts are the CPU's
    print("\n".join(lines), f"\nfinite env phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t_slice = time.perf_counter()
    buffer, ring, space, line = fill_offline_ring(torch)  # raises unless every ring is full
    print(line, f"\noffline ring phase: {time.perf_counter() - t_slice:.1f} s [{smi}]", flush=True)
    for kind in OFFLINE_KINDS:
        t0 = time.perf_counter()
        name = f"offline_{kind}_pixels"
        # raises unless graphs equal eager and gather_rows ran exactly as counted per update
        by_path[name], lines = offline_pixel_path(torch, kind, buffer, ring, space)
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    del buffer, ring
    torch.cuda.empty_cache()
    expert = {}
    for path, task in (("offline_cartpole", "cartpole"), ("offline_pendulum", "pendulum")):
        t0 = time.perf_counter()
        env, data, data_state, _, line = expert_dataset(torch, task)  # raises below the expert's threshold
        expert[task] = (env, data, data_state)
        by_path[path], lines = offline_classic_path(torch, path, expert[task])  # raises below the threshold
        print(line, "\n" + "\n".join(lines), f"\n{path} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for name in MB_THRESHOLD:
        t0 = time.perf_counter()
        by_path[name], lines = modelbased_path(torch, name, expert["pendulum"])  # raises below the threshold
        print("\n".join(lines), f"\n{name} path phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    print(f"the offline slice's phases (38-44): {time.perf_counter() - t_slice:.1f} s [{smi}]", flush=True)
    t_slice = time.perf_counter()
    paths = [("hl_sac_halfcheetah", hl_sac_halfcheetah_path), ("hl_ppo_halfcheetah", hl_ppo_halfcheetah_path),
             ("hl_dqn_cartpole", hl_dqn_cartpole_path), ("hl_dqn_cartpole_per", hl_dqn_cartpole_per_path),
             ("marl_tictactoe", marl_tictactoe_path), ("classic_envs", classic_envs_phase)]
    for name, path in paths:
        t0 = time.perf_counter()
        by_path[name], lines = path(torch)  # raises on a failed check, a launch count or below a threshold
        print("\n".join(lines), f"\n{name} phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    print(f"the high-level, multi-agent and classic-env phases (45-50): {time.perf_counter() - t_slice:.1f} s [{smi}]",
          flush=True)
    t_slice = time.perf_counter()
    paths = [("dp_dqn_pixels", dp_dqn_pixels_phase), ("dp_ppo_halfcheetah", dp_ppo_halfcheetah_phase),
             ("seeded_eval", seeded_eval_phase), ("dp_trpo_halfcheetah", dp_trpo_halfcheetah_phase),
             ("dp_sac_halfcheetah", dp_sac_halfcheetah_phase)]
    for name, path in paths:
        t0 = time.perf_counter()
        by_path[name], lines = path(torch)  # raises unless bit-identical to the trainer's programs, or on a launch count
        print("\n".join(lines), f"\n{name} phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    print(f"the mesh and multi-seed phases (51-55): {time.perf_counter() - t_slice:.1f} s [{smi}]", flush=True)
    t0 = time.perf_counter()
    launches, lines = examples_phase(torch, smi)  # raises on a launch count, a tree or a non-finite result
    by_path.update(launches)
    print("\n".join(lines), f"\nthe examples phase (56): {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    t_slice = time.perf_counter()
    t0 = time.perf_counter()
    # raises unless one launch per vector step over every seed's rows, one replay per megastep, lane 1 bit-equal
    by_path["seed_vmap_sac_halfcheetah"], by_path["seed_vmap_one_seed"], seed_stack, lines = seed_vmap_phase(torch, smi)
    print("\n".join(lines), f"\nseed_vmap_sac_halfcheetah phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    for name, phase in (("benchmark_throughput", benchmark_throughput_phase),
                        ("benchmark_offpolicy", benchmark_offpolicy_phase), ("benchmark_host", benchmark_host_phase)):
        t0 = time.perf_counter()
        by_path[name], lines = phase(torch, smi)  # raises on a launch, a step count or a rate that is not positive
        print("\n".join(lines), f"\n{name} phase: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    print(f"the benchmark scripts' phases (59-62): {time.perf_counter() - t_slice:.1f} s [{smi}]", flush=True)
    by_name = {record["name"]: record for record in records}
    by_name["gather_rows"]["update_burst"] = burst_gather  # the 4,096-row gathers of update_burst_pixels
    by_name["physics_fused"]["ppo_16k"] = at_scale  # HalfCheetah at E = 16,384, on ppo_halfcheetah_16k's state
    by_name["physics_fused"]["seed_stack"] = seed_stack  # 3 seeds' 32 envs in one launch, on seed_vmap's state
    for record in records:
        record["launches_by_path"] = {kind: n[record["name"]] for kind, n in by_path.items()}
        record["launches"] = sum(record["launches_by_path"].values())
        if record["launches"] == 0:
            raise AssertionError(f"no path launched {record['name']}")

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
