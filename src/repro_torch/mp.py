"""``repro_torch.mp``: the public multi-precision API facade (port of
``repro.mp``).

One import gives the run-time reconfiguration surface of the paper's
multiplier: the six modes, formats registered at run time, the AUTO
controller, scoped contexts and policies.

    import numpy as np
    import repro_torch.mp as mp
    from repro_torch.core.limbs import dd_from_f64

    y = mp.mp_matmul(a, b, "M16")                    # modes 2-4 (M8/M16/M23)
    y = mp.mp_matmul(a, b, mp.AUTO)                  # mode 1: operand analysis
    M30 = mp.register_format("M30", mantissa_bits=30, n_limbs=4, max_order=3)
    y = mp.mp_matmul(a, b, M30)                      # a width minted at run time
    y = mp.mp_matmul(dd_from_f64(a64), dd_from_f64(b64), "M52")  # modes 5-6
    with mp.context(backend="ref", auto_candidates=("M8", M30)):
        y = mp.mp_matmul(a, b, mp.AUTO)

Operands live on the card (``cuda``, the hand-written kernels) or on the CPU,
where every kernel wrapper runs its plain PyTorch version
(``dd_from_f64(x, device="cpu")`` for a DD pair there).

Backends (``available_backends``): ``cuda``, ``ref`` and ``sharded``, the
K-sharded path across the ranks of a ``torch.distributed`` process group
(``launch.mesh.init_distributed``; the mesh from the call, the context's
``mesh`` or the whole world), plus any registered at run time:

    with mp.context(backend="sharded"):             # every rank runs this
        y = mp.mp_matmul(a, b, "M16")               # one all-reduce
    mp.register_backend("mine", lambda a, b, fmt: ...)  # then
    mp.unregister_backend("mine")                   # (built-ins reserved)
    step = mp.pin_backend(step, "sharded")

The autotune switch (``autotune_enabled``: ``mp.configure(autotune=True)``
or ``REPRO_MP_AUTOTUNE=1``) lets dispatch sweep the kernels' bit-neutral
launch parameters on a table miss (``kernels/autotune.py``).  Every op is
differentiable, AUTO
included, with the JAX facade's backward formats (``bwd_mode``,
``dgrad_mode``, ``wgrad_mode``).  Beyond the JAX facade the
port exports the paper's mode table (``MODE_TABLE``, ``STATIC_MODES``,
``spec``, ``mode_for_limbs``, ``validate_mode_pair``; JAX's ``repro.core``
exports them).
"""
from repro_torch.core.formats import (  # noqa: F401
    FormatLike,
    MPFormat,
    PrecisionMode,
    available_formats,
    format_def,
    get_format,
    is_auto,
    register_format,
    resolve,
    unregister_format,
)
from repro_torch.core.context import (  # noqa: F401
    DEFAULT_AUTO_CANDIDATES,
    PrecisionContext,
    autotune_enabled,
    configure,
    context,
    current_context,
    default_context,
    reset_context,
)
from repro_torch.core.policy import (  # noqa: F401
    OpRule,
    PrecisionPolicy,
    get_policy,
)
from repro_torch.core.limbs import PrelimbedWeight, prelimb_weight  # noqa: F401
from repro_torch.core.mpmatmul import (  # noqa: F401
    mode_flops,
    mp_attention,
    mp_dense,
    mp_einsum_qk,
    mp_fused_proj,
    mp_matmul,
    mp_qkv_proj,
    mp_swiglu,
)
from repro_torch.core.auto import (  # noqa: F401
    auto_report,
    mp_matmul_auto,
    select_mode_index,
)
from repro_torch.core.dispatch import (  # noqa: F401
    available_backends,
    pin_backend,
    register_backend,
    unregister_backend,
)
from repro_torch.core.modes import (  # noqa: F401
    MODE_TABLE,
    STATIC_MODES,
    mode_for_limbs,
    spec,
    validate_mode_pair,
)

AUTO = PrecisionMode.AUTO
