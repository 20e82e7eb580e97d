# Hand-written CUDA kernels for Hopper (sm_90a) replacing the Pallas TPU
# kernels, each with a plain PyTorch version (ref.py) and a
# device-dispatching wrapper (ops.py):
#   lsh_hash            - grid-LSH bucket keys, and with the bucket
#                         directory's slots (lsh_hash_resolve), in
#                         csrc/lsh_hash.cu
#   slot_counts         - per-batch bucket occupancy deltas (csrc/bucket_ops.cu)
#   bucket_core_stats   - Definition-4 support / core flags (csrc/bucket_ops.cu)
#   eps_neighbor_counts - exact DBSCAN's eps-ball counts (csrc/pairwise_dist.cu)
#   attention           - GQA flash attention of the LM prefill
#                         (csrc/flash_attention.cu)
from . import ops, ref  # noqa: F401
