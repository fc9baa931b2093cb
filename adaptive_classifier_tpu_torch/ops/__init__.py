"""Device ops: the hand-written CUDA kernels and the plain torch around them.

``launch_counts`` holds, per kernel, how many times its wrapper launched it
on a GPU.  A wrapper adds one where it launches its kernel and nowhere else,
so a run that zeroes the counts, drives a path and reads them back shows
which kernels that path went through.  ``count_launch`` adds under a lock:
serving workers launch kernels from several threads at once, and a bare
``d[k] += 1`` from two threads can lose an increment.
"""

import threading
from typing import Dict

launch_counts: Dict[str, int] = {
    "attention_qkv": 0, "flash_attention": 0, "oneshot_attention": 0,
    "add_layer_norm": 0, "knn_sims": 0, "knn_topk": 0,
    "matmul_int8": 0, "ffn_int8": 0, "proj_residual_ln_int8": 0, "attn_ffn_int8": 0,
}


_counts_lock = threading.Lock()


def count_launch(name: str):
    """One launch of kernel ``name``: called by its wrapper where it
    launches the kernel, and nowhere else."""
    with _counts_lock:
        launch_counts[name] += 1


def reset_launch_counts():
    with _counts_lock:
        for name in launch_counts:
            launch_counts[name] = 0
