"""FP32 operations per element of the port's logistic prox at delta =
1 / tau (an exp, a reciprocal or a division counts as one): the bracket 13,
a bisection step 10 (ceil(log2 delta) of them), the start and 1/delta 7, a
Newton step 14 (5 less the clamped steps, at least 2), a clamped Newton step
18. At delta = 10: 142."""
import math


def flops(cfg: dict, newton_iters: int = 3) -> int:
    delta = 1.0 / float(cfg["tau"])
    nb = math.ceil(math.log2(delta)) if delta > 1 else 0
    return 13 + 10 * nb + 7 + 14 * max(2, 5 - newton_iters) \
        + 18 * newton_iters
