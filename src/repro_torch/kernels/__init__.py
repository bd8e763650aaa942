"""The port's kernels: hand-written CUDA (``csrc/``) behind PyTorch wrappers,
each with its plain PyTorch version and two counters: ``launches`` (kernel
launches, counted where the kernel is launched and nowhere else) and
``plain_calls`` (calls on CPU tensors, which run the plain version).  Beside
them, ``core.auto.mp_matmul_auto.host_reads`` counts the AUTO controller's
reads of its selected format back to the host."""
from repro_torch.kernels.mp_attention import mp_flash_attention, \
    mp_mixed_paged_attention, mp_paged_attention
from repro_torch.kernels.mp_matmul import mp_both_prelimbed_matmul, \
    mp_decompose, mp_fused_matmul, mp_fused_matmul_partials, mp_fused_proj, \
    mp_mixed_prelimbed_matmul, mp_prelimbed_matmul

# every kernel wrapper of the port, by name
KERNELS = {
    "mp_fused_matmul": mp_fused_matmul,
    "mp_fused_proj": mp_fused_proj,
    "mp_flash_attention": mp_flash_attention,
    "mp_decompose": mp_decompose,
    "mp_prelimbed_matmul": mp_prelimbed_matmul,
    "mp_paged_attention": mp_paged_attention,
    "mp_mixed_prelimbed_matmul": mp_mixed_prelimbed_matmul,
    "mp_mixed_paged_attention": mp_mixed_paged_attention,
    "mp_both_prelimbed_matmul": mp_both_prelimbed_matmul,
    "mp_fused_matmul_partials": mp_fused_matmul_partials,
}


def reset_launch_counts() -> None:
    """Zero every wrapper's counters and the AUTO controller's count of
    host reads (``core.auto.mp_matmul_auto.host_reads``)."""
    from repro_torch.core.auto import mp_matmul_auto

    for fn in KERNELS.values():
        fn.launches = 0
        fn.plain_calls = 0
    mp_matmul_auto.host_reads = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def plain_call_counts() -> dict:
    return {name: fn.plain_calls for name, fn in KERNELS.items()}
