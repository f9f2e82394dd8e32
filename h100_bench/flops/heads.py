"""Model FLOPs after the backbone: GPF Grams, the moment head (the iSQRT on the
dense route for N >= D or in the token subspace for N < D, second_proj,
count sketches, third_proj), the classifier and, in training, the per-view
auxiliary classifier.  The iSQRT counts the plain iteration's products
(``isqrt_products(..., least=False)``), not the fewer that kernels 5 and 7
run (``kernel_work/``)."""

from h100_bench.flops import isqrt_products


def _classifier(mcfg: dict, d: int, d_out: int, classes: int, b: int) -> float:
    cls = mcfg.get("classifier", {})
    if cls.get("type", "standard") == "multiscale":
        total = 0.0
        for i in range(3):
            c, m = d // 2 ** i, d_out // 2 ** i
            f = c + m
            total += 2.0 * b * (d * c + d_out * m + f * (f // 2) + (f // 2) * classes)
        s = 3
        return total + 2.0 * b * (4 * s * classes * classes + 2 * s * s * classes)
    if cls.get("fusion_type", "concat") != "add":
        raise NotImplementedError("FLOPs of the 'add' and 'multiscale' classifiers only")
    h = max(d_out // 2, 256)
    proj = (d * d_out + d_out * d_out) if d != d_out else 0
    return 2.0 * b * (proj + d_out * h + h * (h // 2) + (h // 2) * classes)


def heads_flops(spec: dict, b: int, n: int, training: bool) -> float:
    """Heads of a batch of ``b`` images with ``n`` patch tokens each."""
    mcfg = spec["port_config"]["model"]
    d = spec["architecture"]["num_features"]
    moment = mcfg.get("moment", {})
    d_out, iters = moment.get("d_out", 1024), moment.get("isqrt_iterations", 5)
    k = -(-min(moment.get("sketch_dim", 4096), 4 * d) // 128) * 128
    classes = spec["num_classes"]
    grams = (2 if training else 1) * 2.0 * b * n * n * d
    if n >= d:  # the dense route
        isqrt = (2.0 * b * d * n * d             # M2 = Zc^T (W Zc)
                 + isqrt_products("dense", iters, least=False) * 2.0 * b * d ** 3)
    else:
        isqrt = (2.0 * b * n * d * n             # S = B^ A^T
                 + isqrt_products("subspace", iters, least=False) * 2.0 * b * n ** 3
                 + 2.0 * b * n * n * d           # G B^
                 + 2.0 * b * d * n * d)          # A^T (G B^)
    moments = (2.0 * b * n * n * d            # W Zc
               + 2 * 2.0 * b * n * d           # the weighted mean, the pooled third-order input
               + isqrt
               + 2.0 * b * (d * (d + 1) // 2) * (d_out // 2)
               + 3 * 2.0 * b * d * k + 2.0 * b * k * (d_out - d_out // 2))
    aux = 2 * 2.0 * b * d * classes if training else 0.0
    return grams + moments + _classifier(mcfg, d, d_out, classes, b) + aux
