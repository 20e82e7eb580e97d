"""End to end on the port: train a granite-family LM for a few
hundred steps on the synthetic pipeline with DBSCAN curation enabled.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \
        [--device cuda]

``examples/train_lm.py`` over the port: the reference example's flags
and its argv to ``repro_torch.launch.train``, plus ``--device`` (where
the model trains: "cuda" by default, "cpu" asked for explicitly).
Defaults are CPU-feasible (~5M params); pass --full-100m for the
~124M-param preset (12 layers x d_model 768, vocab 32k).
"""
import argparse

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: cuda)")
    args = ap.parse_args(argv)
    run = [
        "--arch", "granite-20b",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--curation", "balance",
        "--ckpt-every", "100",
    ]
    run += ["--preset", "100m"] if args.full_100m else [
        "--smoke", "--d-model-override", "512"]
    return train_main(run + ["--device", args.device])


if __name__ == "__main__":
    main()
