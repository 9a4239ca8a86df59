"""Offline BCQ from an EXTERNAL d4rl-format dataset file, the port of
``examples/offline/d4rl_bcq.py`` (the analogue of the reference's
examples/offline/d4rl_bcq.py, which trains from ``d4rl.qlearning_dataset``
downloads, reference examples/offline/utils.py:10).

The d4rl package and its downloads are not available, so the dataset FILE is
synthesized once by the behavior-policy gatherer and written in the d4rl
HDF5 layout (observations / actions / rewards / terminals / timeouts /
next_observations); training then reads ONLY the file through
:func:`tianshou_tpu_torch.utils.persistence.load_d4rl_hdf5`, the ingestion
path a real d4rl download would take. Both need ``h5py``.

    python examples_torch/offline/d4rl_bcq.py [--dataset PATH] [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse
from pathlib import Path

import numpy as np

from examples_torch.common import add_device_arg, setup


def make_bcq(env):
    from tianshou_tpu_torch.algorithm.imitation.bcq import BCQ
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import VAE, ContinuousCritic, Perturbation

    return BCQ(
        actor_perturbation=Perturbation(hidden_sizes=(64, 64), action_dim=1, max_action=1.0, phi=0.05, input_dim=3),
        critic=ContinuousCritic(hidden_sizes=(64, 64), input_dim=3, action_dim=1),
        vae=VAE(encoder_hidden=(64,), decoder_hidden=(64,), action_dim=1, latent_dim=2, max_action=1.0, input_dim=3),
        action_space=env.action_space,
        actor_optim=AdamOptimizerFactory(lr=1e-3),
        critic_optim=AdamOptimizerFactory(lr=1e-3),
        vae_optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.99, tau=0.005, forward_sampled_times=20, num_sampled_action=10,
    )


def export_d4rl_hdf5(path: str, buf, state) -> None:
    """Flatten a buffer into the d4rl qlearning_dataset HDF5 layout."""
    import h5py

    data = state.data.map(lambda x: x.cpu().numpy())
    fields: dict[str, list] = {k: [] for k in
                               ("observations", "actions", "rewards", "terminals", "timeouts", "next_observations")}
    for e in range(buf.num_envs):
        order = buf.chronological_indices(state, e) % buf.capacity
        fields["observations"].append(data.obs[e][order])
        fields["actions"].append(data.act[e][order])
        fields["rewards"].append(data.rew[e][order])
        fields["terminals"].append(data.terminated[e][order])
        fields["timeouts"].append(data.truncated[e][order])
        fields["next_observations"].append(data.obs_next[e][order])
    with h5py.File(path, "w") as f:
        for k, v in fields.items():
            f.create_dataset(k, data=np.concatenate(v))


def make_dataset(path: str, generator) -> None:
    from examples_torch.offline._gather import gather_pendulum

    _, data, dstate, _, _ = gather_pendulum(generator)
    export_d4rl_hdf5(path, data, dstate)
    print(f"[d4rl_bcq] synthesized d4rl-format dataset -> {path}", flush=True)


def train(dataset_path: str, seed: int = 0, epochs: int = 10, device=None):
    from tianshou_tpu_torch.env.classic.pendulum import Pendulum
    from tianshou_tpu_torch.utils.persistence import load_d4rl_hdf5

    from examples_torch.offline._gather import train_offline

    dev, gen = setup(device, seed)
    data, dstate = load_d4rl_hdf5(dataset_path, device=dev)
    env = Pendulum()
    return train_offline(make_bcq(env), env, data, dstate, gen, max_epochs=epochs, batch_size=128,
                         label=f"offline BCQ from {dataset_path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="/tmp/pendulum_d4rl.hdf5")
    p.add_argument("--epochs", type=int, default=10)
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not Path(args.dataset).exists():
        make_dataset(args.dataset, setup(args.device, 0)[1])
    return train(args.dataset, epochs=args.epochs, device=args.device)


if __name__ == "__main__":
    main()
