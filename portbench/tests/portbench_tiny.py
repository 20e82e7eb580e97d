"""The CPU tests' size of each configuration and the limits of the
check at that size.

Each width is cut; the family's shape is kept (one kv head for
granite-20b, grouped kv heads and top-k routing for granite-moe, whose
tokens a step are raised so that routing flips average out as at the
card's size).  The limits are set as the card's are, from readings at
this size (the CPU, 6-12 seeds): granite-20b sound at most 1.85e-4 /
1.09e-3 / 6.85e-4 (loss / grad / update gap), the float8 control at
least 7.1e-4 / 2.86e-3 / 2.13e-3; granite-moe sound at most 2.53e-4 /
5.12e-3 / 3.53e-3, the control at least 2.91e-4 / 1.30e-2 / 4.10e-3.
"""

from portbench import manifest

SIZES = {
    "granite-20b": (dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
                         d_ff=256, vocab_size=300),
                    dict(batch=4, seq=64),
                    dict(loss_gap=4e-4, grad_gap=2e-3, update_gap=1.2e-3)),
    "granite-moe-1b-a400m": (dict(n_layers=2, d_model=64, n_heads=4,
                                  n_kv_heads=2, d_ff=32, vocab_size=300,
                                  n_experts=8, top_k=4),
                             dict(batch=4, seq=256),
                             dict(loss_gap=6e-4, grad_gap=8e-3,
                                  update_gap=6e-3)),
}
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def tiny(cell_name):
    """(cell, session keywords, limits) at the tests' size."""
    cell = manifest.cell(cell_name)
    arch, traffic, limits = SIZES[cell.config["name"]]
    return cell, {"arch": {**cell.config["arch"], **arch},
                  "traffic": {**cell.traffic, **traffic}}, \
        {**cell.limits, **limits}


def one_thread():
    """Run a test's tensor work on one thread (restored after), so that
    the test workers, one a core, do not oversubscribe the host."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
