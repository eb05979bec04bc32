"""Measure lax.sort cost vs channel count / row length on the ambient
device (each call ended by a scalar fetch)."""

import time

import jax
import jax.numpy as jnp
import numpy as np


def time_sort(h, n, n_payload, repeats=5, key_dtype=jnp.uint32):
    rng = np.random.default_rng(0)
    key = jnp.asarray(
        rng.integers(0, 2**31, size=(h, n), dtype=np.uint32).astype(
            np.dtype(key_dtype)
        )
    )
    payloads = tuple(
        jnp.asarray(rng.normal(size=(h, n)).astype(np.float32))
        for _ in range(n_payload)
    )
    weights = jnp.asarray(rng.normal(size=(h, n)).astype(np.float32))

    @jax.jit
    def run(key, payloads):
        out = jax.lax.sort((key,) + payloads, dimension=-1, num_keys=1)
        # order-sensitive reduction so XLA cannot elide the sort
        acc = jnp.sum(out[0].astype(jnp.float32) * weights)
        for p in out[1:]:
            acc = acc + jnp.sum(p * weights)
        return acc

    float(run(key, payloads))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(run(key, payloads))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    print(f"platform: {jax.devices()[0].platform}")
    # fetch-to-fetch baseline (dispatch + scalar fetch overhead)
    base = time_sort(1, 128, 0)
    print(f"tiny-op floor: {base*1e3:.2f} ms")
    for h, n in [(64, 65536), (64, 32768)]:
        for c in [0, 1, 2, 3, 5, 7, 9]:
            t = time_sort(h, n, c)
            print(f"[{h},{n}] key+{c} payloads: {t*1e3:8.2f} ms "
                  f"(-floor: {(t-base)*1e3:8.2f})", flush=True)


if __name__ == "__main__":
    main()
