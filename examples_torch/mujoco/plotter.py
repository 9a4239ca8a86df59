"""Plot MuJoCo learning curves from tensorboard logs, the port of
``examples/mujoco/plotter.py`` (the analogue of the reference's
examples/mujoco/plotter.py / analysis.py), over the rliable evaluation
helpers (IQM and stratified bootstrap bands). It reads logs and draws on the
host, so it alone of the port's scripts takes no ``--device``.

    python examples_torch/mujoco/plotter.py log/sac_halfcheetah_seed* -o curve.png
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from tianshou_tpu_torch.evaluation.rliable_evaluation import load_and_eval_experiments, plot_iqm_curve


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("log_dirs", nargs="+", help="one tensorboard run dir per seed")
    p.add_argument("-o", "--output", default="curve.png")
    p.add_argument("--title", default="")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    grid, iqm_c, lo, hi, summary = load_and_eval_experiments(args.log_dirs)
    print(
        f"runs={summary.n_runs} final IQM={summary.iqm:.1f} "
        f"mean={summary.mean:.1f} median={summary.median:.1f} "
        f"95% CI=[{summary.ci_low:.1f}, {summary.ci_high:.1f}]"
    )
    plot_iqm_curve(grid, iqm_c, lo, hi, title=args.title, out_path=args.output)
    print(f"wrote {args.output}")
    return summary


if __name__ == "__main__":
    main()
