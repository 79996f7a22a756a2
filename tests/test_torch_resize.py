"""The port's batched bilinear resize (spacedrive_tpu_torch/ops/resize.py)
against the JAX package's (spacedrive_tpu/ops/resize_jax.py), on the CPU.

The same numpy-seeded u8 batches go through both. ``target_dims`` is equal
on a grid of photo-library shapes and edges. ``resize_batch`` is held to
JAX's at max |diff| <= 1 on one padded batch with mixed sizes, an image
below the canvas, a 1x1 image, a panorama after the host reduce and
padding lanes. The reference sums dense matrix products, the port two
gathered taps in a product's order, both in fp32, so a value could round
the other way at a tie: the test states the count of differing values (0
on this CPU when written). The port pads a batch only to its
largest image, the reference to 256-multiples and a power-of-two count:
``resize_batch_host`` crops are held equal, a mixed batch equals each image
alone, the mask zeroes the canvas outside the target, and the pixels do
not depend on the caller's matmul precision, which the resize leaves as it
finds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import resize_jax
from spacedrive_tpu_torch.ops import resize

CPU = torch.device("cpu")

#: (w, h): camera frames, phone portraits, screenshots, web images,
#: panoramas, the canvas' edges and a 1x1
GRID = [(4000, 3000), (3024, 4032), (1920, 1080), (1080, 1920), (640, 480), (300, 200),
        (8000, 1000), (1000, 8000), (8000, 200), (3000, 60), (1, 1), (1, 5000), (512, 512),
        (513, 511), (511, 513), (512, 513), (600, 436), (1024, 1024), (1000, 25), (2, 1)]


def test_constants_and_target_dims_match_the_reference():
    assert resize.CANVAS == resize_jax.CANVAS
    got = [resize.target_dims(w, h) for w, h in GRID]
    assert got == [resize_jax.target_dims(w, h) for w, h in GRID]
    assert got[0] == (384, 512) and got[5] == (200, 300) and got[10] == (1, 1)


def mixed_batch():
    """One padded batch: (600, 800) above the canvas, (300, 200) below it,
    1x1, a 8000x200 panorama after the host's 8x reduce (25, 1000), a
    (512, 512) at the canvas, and two padding lanes (1x1 source and target,
    as the reference pads)."""
    rng = np.random.default_rng(21)
    shapes = [(600, 800), (200, 300), (1, 1), (25, 1000), (512, 512)]
    batch = np.zeros((len(shapes) + 2, 600, 1000, 3), np.uint8)
    src = np.ones((len(batch), 2), np.int32)
    tgt = np.ones((len(batch), 2), np.int32)
    for i, (h, w) in enumerate(shapes):
        batch[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        src[i] = (h, w)
        tgt[i] = resize.target_dims(w, h)
    batch[len(shapes):] = rng.integers(0, 256, (2, 600, 1000, 3), dtype=np.uint8)
    return batch, src, tgt


def test_resize_batch_matches_the_reference():
    batch, src, tgt = mixed_batch()
    want = np.asarray(resize_jax.resize_batch(jnp.asarray(batch), jnp.asarray(src),
                                              jnp.asarray(tgt)))
    got = resize.resize_batch(torch.from_numpy(batch), torch.from_numpy(src),
                              torch.from_numpy(tgt))
    assert got.dtype == torch.uint8 and got.shape == (7, 512, 512, 3)
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    # the count of differing values on this CPU when the test was written
    assert int((diff != 0).sum()) == 0
    assert resize.CALLS[("cpu", (7, 600, 1000))] >= 1


def test_resize_batch_host_crops_match_the_reference():
    batch, src, _tgt = mixed_batch()
    arrays = [batch[i, : src[i, 0], : src[i, 1]] for i in range(5)]
    want = resize_jax.resize_batch_host(arrays)
    got = resize.resize_batch_host(arrays, CPU)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 1
        assert np.array_equal(g, w)
    # images below the canvas pass through
    assert np.array_equal(got[1], arrays[1]) and np.array_equal(got[2], arrays[2])
    with pytest.raises(ValueError):
        resize.resize_batch_host([np.zeros((1025, 10, 3), np.uint8)], CPU)


def test_mixed_batch_equals_each_image_alone():
    rng = np.random.default_rng(4)
    shapes = [(300, 400), (700, 500), (50, 900), (640, 640)]
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]
    batched = resize.resize_batch_host(imgs, CPU)
    for img, out in zip(imgs, batched):
        assert np.array_equal(out, resize.resize_batch_host([img], CPU)[0])


def test_mask_zeroes_outside_the_target():
    img = torch.full((1, 800, 800, 3), 200, dtype=torch.uint8)
    th, tw = resize.target_dims(800, 800)
    full = resize.resize_batch(img, torch.tensor([[800, 800]], dtype=torch.int32),
                               torch.tensor([[th, tw]], dtype=torch.int32)).numpy()
    assert (full[0, th:] == 0).all() and (full[0, :, tw:] == 0).all()
    assert (full[0, :th, :tw] == 200).all()


def test_pixels_do_not_depend_on_the_matmul_precision():
    batch, src, tgt = mixed_batch()
    args = (torch.from_numpy(batch[:2]), torch.from_numpy(src[:2]), torch.from_numpy(tgt[:2]))
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        tf32 = resize.resize_batch(*args)
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(tf32, resize.resize_batch(*args))
    with pytest.raises(ValueError):
        resize.resize_batch(args[0].to(torch.int16), args[1], args[2])
