"""Device ops: the hand-written CUDA kernels and the plain torch around them.

``launch_counts`` holds, per kernel, how many times its wrapper launched it
on a GPU.  A wrapper adds one where it launches its kernel and nowhere else,
so a run that zeroes the counts, drives a path and reads them back shows
which kernels that path went through.
"""

from typing import Dict

launch_counts: Dict[str, int] = {
    "attention_qkv": 0, "flash_attention": 0, "oneshot_attention": 0,
    "add_layer_norm": 0, "knn_sims": 0, "knn_topk": 0,
    "matmul_int8": 0, "ffn_int8": 0, "proj_residual_ln_int8": 0, "attn_ffn_int8": 0,
}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0
