"""The port's kernels: hand-written CUDA (``csrc/``) behind PyTorch wrappers,
each with its plain PyTorch version and two counters: ``launches`` (kernel
launches, counted where the kernel is launched and nowhere else) and
``plain_calls`` (calls on CPU tensors, which run the plain version); the
fused matmul and its partials epilogue, the fused projection and the
pre-limbed, mixed-lane and both-prelimbed matmuls also count their launches
per route (``routes``).  Beside
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
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)
    mp_matmul_auto.host_reads = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict:
    """Launches per route of the wrappers with more than one (the fused
    matmul and its partials epilogue: ``mp_matmul.ROUTES``; the fused
    projection: ``PROJ_ROUTES``; the pre-limbed and mixed-lane matmuls:
    ``PRELIMBED_ROUTES``; the both-prelimbed matmul: ``BOTH_ROUTES``)."""
    return {name: dict(fn.routes) for name, fn in KERNELS.items()
            if hasattr(fn, "routes")}


def plain_call_counts() -> dict:
    return {name: fn.plain_calls for name, fn in KERNELS.items()}
