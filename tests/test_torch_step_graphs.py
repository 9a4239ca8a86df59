"""The on-policy trainer's step-graph route, on the CPU (the port only).

A rollout update of more than ``OnPolicyTrainer.STEP_GRAPHS_ABOVE`` gradient
steps runs eagerly inside a ``StepGraphs`` block, each minibatch step through
``graphed_step``: on the card a replayed CUDA graph of one step
(``tests/test_torch_cuda.py::test_step_graphs_match_the_eager_update_on_cuda``
and ``chip_smoke.py``'s ``hl_ppo_halfcheetah`` hold it to the eager update bit
for bit). On the CPU a step runs as it is, so the two routes give the same
bits: stats, weights, Adam's state and the step, for PPO (plain, and with
recomputed advantages and the KL guard) and A2C, over two rollout updates.
A step's program is built once per update, or once per pass where the pass
recomputes the advantages (its batch's tensors change), and the block leaves
no program behind, also when the update raises.
"""

import copy

import pytest
import torch

from tianshou_tpu_torch.algorithm.modelfree.a2c import A2C
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams
from tianshou_tpu_torch.utils import graph
from tianshou_tpu_torch.utils.graph import StepGraphs, graphed_step
from tianshou_tpu_torch.utils.tree import tree_leaves, tree_map
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E, T, REPEAT, BATCH = 4, 16, 2, 16
ALGOS = {
    "ppo": lambda kw: PPO(eps_clip=0.2, ent_coef=0.01, **kw),
    "ppo_recompute_kl": lambda kw: PPO(eps_clip=0.2, recompute_advantage=True, target_kl=0.01, **kw),
    "a2c": lambda kw: A2C(ent_coef=0.01, **kw),
}


def make(kind):
    torch.manual_seed(0)
    algo = ALGOS[kind](dict(actor=DiscreteActor((16, 16), 2, input_dim=4),
                            critic=DiscreteCritic((16, 16), input_dim=4), action_space=CartPole().action_space,
                            optim=AdamOptimizerFactory(lr=1e-3, max_grad_norm=0.5)))
    coll = DeviceCollector(VectorDeviceEnv(CartPole(), E, device="cpu"), algo, None)
    return algo, coll


@pytest.mark.parametrize("kind", sorted(ALGOS))
def test_the_step_route_gives_the_whole_program_bits_on_cpu(kind, monkeypatch):
    algo, coll = make(kind)
    ts = algo.init("cpu")
    gen = torch.Generator().manual_seed(1)
    rollout = coll.collect(ts, coll.reset(gen), None, gen, T, keep_rollout=True)[2].rollout
    n_grad = algo.rollout_grad_steps(T * E, REPEAT, BATCH)
    built = []
    init = graph.Graphed.__init__
    monkeypatch.setattr(graph.Graphed, "__init__", lambda self, *a, **kw: built.append(kw["name"]) or init(self, *a, **kw))
    sides = {}
    for above in (n_grad, n_grad - 1):  # the whole program, then the step route
        s_ts, s_gen = copy.deepcopy(ts), torch.Generator().manual_seed(2)
        trainer = OnPolicyTrainer(algo, coll, None, OnPolicyTrainerParams(
            batch_size=BATCH, update_step_num_repetitions=REPEAT, verbose=False))
        trainer.STEP_GRAPHS_ABOVE = above
        stats = [trainer.update_rollout(s_ts, rollout, s_gen).map(torch.clone) for _ in range(2)]
        assert not graph._ACTIVE and (above < n_grad or len(trainer.graph_pool.graphs) == 1)
        sides[above] = (stats, s_ts)
    # a step is built once per update, and once per pass where the pass recomputes the advantages
    steps = 2 * (REPEAT if kind == "ppo_recompute_kl" else 1)
    assert built == ["update_rollout 2 16"] + [f"{type(algo).__name__} step"] * steps
    (a_stats, a_ts), (b_stats, b_ts) = sides[n_grad], sides[n_grad - 1]
    assert int(a_ts.step) == int(b_ts.step) == 2 * n_grad
    for x, y in zip(a_stats, b_stats):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x.keys())
    for k, v in a_ts.model.state_dict().items():
        assert torch.equal(v, b_ts.model.state_dict()[k]), k
    for x, y in zip(tree_leaves(a_ts.optim.state_dict()["state"]), tree_leaves(b_ts.optim.state_dict()["state"])):
        assert torch.equal(x, y)


def test_graphed_step_runs_the_step_off_the_card_and_the_block_cleans_up():
    idx = torch.arange(3)
    fn = lambda i: Batch(x=i.sum())  # noqa: E731
    assert int(graphed_step(None, (), fn, idx).x) == 3
    with pytest.raises(RuntimeError, match="inside"):
        with StepGraphs("cpu") as steps:
            assert int(graphed_step(steps, (idx,), fn, idx).x) == 3 and int(graphed_step(steps, (idx,), fn, idx + 1).x) == 6
            assert graph._ACTIVE == [steps] and len(steps._held) == 1
            raise RuntimeError("inside")
    assert not graph._ACTIVE and not steps._held


def test_tree_leaves_follow_tree_map_order():
    tree = {"b": torch.ones(1), "a": Batch(d=torch.zeros(2)), "c": [torch.ones(3), (torch.ones(4),)],
            "e": Batch(f=torch.ones(5))}
    seen = []
    tree_map(lambda x: seen.append(x) or x, tree)
    assert [x.numel() for x in tree_leaves(tree)] == [x.numel() for x in seen] == [1, 2, 3, 4, 5]
