"""The port's kernels: hand-written CUDA (``csrc/``) behind PyTorch wrappers,
each with its plain PyTorch version and two counters: ``launches`` (kernel
launches, counted where the kernel is launched and nowhere else) and
``plain_calls`` (calls on CPU tensors, which run the plain version)."""
from repro_torch.kernels.mp_attention import mp_flash_attention, \
    mp_mixed_paged_attention, mp_paged_attention
from repro_torch.kernels.mp_matmul import mp_decompose, mp_fused_matmul, \
    mp_fused_proj, mp_mixed_prelimbed_matmul, mp_prelimbed_matmul

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
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.plain_calls = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def plain_call_counts() -> dict:
    return {name: fn.plain_calls for name, fn in KERNELS.items()}
