"""Time the port's host decoder against Pillow on one fixture, one thread.

    python tests/fixtures/images/bench_decode.py [file] [reps]

Prints, for ``a_500x375_420.jpg`` (a 500x375 4:2:0 JPEG) unless another
fixture is named: the whole decode (the port's ``decode_full`` against
``np.asarray(Image.open(p).convert("RGB"))``) and the train and eval
decodes at 224 px of one image (the port's ``decode_image_batch`` against
the JAX package's, its pool cut to one thread), in µs an image, the median
of ``reps`` rounds of 20 calls.  Needs Pillow and the JAX package: it runs
where the tests run, not on the card's host.
"""

import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import datasets as jds  # noqa: E402
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import datasets as tds  # noqa: E402
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import image_native  # noqa: E402


def per_call_us(fn, reps: int, calls: int = 20) -> float:
    fn()
    rounds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(rounds)


def main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "a_500x375_420.jpg"
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 7
    path = os.path.join(HERE, name)
    one = np.asarray([path], object)
    jds._DECODE_POOL = ThreadPoolExecutor(max_workers=1)

    def pil_full():
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    rows = {
        "full": (lambda: image_native.decode_full(path), pil_full),
        "train_224": (lambda: image_native.decode_resized(
            [path], *tds.decode_geometry(image_native.probe_sizes([path]), 224, True, 0), 224,
            threads=1), lambda: jds.decode_image_batch(one, 224, True, 0)),
        "eval_224": (lambda: image_native.decode_resized(
            [path], *tds.decode_geometry(image_native.probe_sizes([path]), 224, False, 0), 224,
            threads=1), lambda: jds.decode_image_batch(one, 224, False, 0)),
    }
    w, h = (int(v) for v in image_native.probe_sizes([path])[0])
    print(f"{name} ({w}x{h}), one thread, {os.cpu_count()} cores on this host")
    for what, (port, pil) in rows.items():
        p, q = per_call_us(port, reps), per_call_us(pil, reps)
        print(f"{what}: port {p:.1f} us, Pillow {q:.1f} us (port / Pillow {p / q:.2f})")


if __name__ == "__main__":
    main()
