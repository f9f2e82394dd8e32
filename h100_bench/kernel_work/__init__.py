"""The least work of each hand-written kernel, from shapes.

One module per kernel wrapper of the program, named as the wrapper's launch
counter is (``<wrapper>.launches``).  Each gives ``WRAPPER`` (module and
function of the counter), ``SOURCE`` (the CUDA source the wrapper builds),
``SYMBOLS`` (a regular expression matching its device kernels' names in a
profiler trace) and ``work(spec, batch, serving)``: a list of ``(bytes,
flops)`` for one serving forward or one training step of ``batch`` images
(both views in training), one entry per layer that launches it.  Bytes count each input read once and each output
written once; a launch's bound is the larger of bytes over 3.35 TB/s and
flops over the peak of its dtype (``PEAK_FLOPS``): the model's (bf16 or
fp32), or the module's own ``DTYPE`` where the kernel computes in another
type.  A product that a kernel keeps fp32-accurate (kernels 5 and 7) counts
``SPLIT_PRODUCTS`` bf16 tensor-core products, the fastest way the card has to
that accuracy, at the bf16 peak: one rule for every such kernel, and never
the fp32 SIMT peak, which kernel 7 already runs past."""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor cores; fp32 without
# an fp32-accurate product as bf16 cross products: three bf16 terms a factor,
# the six of the leading orders
SPLIT_PRODUCTS = 6


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def element_size(spec: dict) -> int:
    return 2 if spec["port_config"]["model"].get("bf16", False) else 4


def dtype_name(spec: dict) -> str:
    return "bfloat16" if spec["port_config"]["model"].get("bf16", False) else "float32"


def swin_stages(arch: dict):
    """(Hp, C, heads, blocks, shifted blocks, ws, H) of each stage; a block
    is masked where it shifts or its canvas is padded."""
    h = arch["img_size"] // arch["patch_size"]
    c = arch["embed_dim"]
    for depth, heads in zip(arch["depths"], arch["num_heads"]):
        ws = min(arch["window_size"], h)
        hp = -(-h // ws) * ws
        yield hp, c, heads, depth, (depth // 2 if h > ws else 0), ws, h
        h, c = h // 2, c * 2


def isqrt_dense_work(spec: dict, batch: int, per_product: int = 1) -> list:
    """A Newton–Schulz kernel of the dense moment route (5, 5′, 5″): M read
    and M^-1/2 written, [B, D, D] in the model's dtype; the least D x D
    products (``flops.isqrt_products``), each of 2 D^3 flops a matrix times
    ``per_product`` tensor-core products.  One launch a forward, on the
    anchor view's batch in training too."""
    from h100_bench.flops import isqrt_products
    d = spec["architecture"]["num_features"]
    k = spec["port_config"]["model"].get("moment", {}).get("isqrt_iterations", 5)
    nbytes = 2 * batch * d * d * element_size(spec)
    products = isqrt_products("dense", k, least=True) * per_product
    return [(nbytes, products * 2.0 * batch * d ** 3)]
