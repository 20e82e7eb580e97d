"""Serve a small model with batched requests + request clustering, on the
port.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cuda]

``examples/serve_lm.py`` over the port: the reference example's argv to
``repro_torch.launch.serve``, plus ``--device`` (where the model runs:
"cuda" by default, "cpu" asked for explicitly).  :func:`main`'s
``requests`` cuts the 12 requests for the tests.
"""
import argparse

from repro_torch.launch.serve import main as serve_main

#: ``examples/serve_lm.py``'s arguments
ARGV = ["--arch", "mamba2-780m", "--smoke", "--requests", "12",
        "--batch", "4", "--cluster"]


def main(argv=None, *, requests=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: cuda)")
    args = ap.parse_args(argv)
    run = list(ARGV)
    if requests is not None:
        run[run.index("--requests") + 1] = str(requests)
    return serve_main(run + ["--device", args.device])


if __name__ == "__main__":
    main()
