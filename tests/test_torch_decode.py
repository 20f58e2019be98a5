"""Gray-code decode: the port's plain decode (the CPU side of the CUDA
kernel ``csrc/decode.cu``) against the JAX package's Pallas kernel in
interpret mode and its XLA path, on the same uint8 inputs.

Tolerance: exact everywhere — maps and masks are integers/booleans, and the
uint8 percentile is an exact histogram order statistic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.config import (
    DecodeConfig as JDecodeConfig,
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu.ops import decode as jdecode
from structured_light_for_3d_model_replication_tpu.ops import patterns as jpatterns
from structured_light_for_3d_model_replication_tpu.ops.decode_pallas import (
    decode_maps_pallas,
)
from structured_light_for_3d_model_replication_tpu_torch.config import (
    DecodeConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import decode
from structured_light_for_3d_model_replication_tpu_torch.ops import patterns

from .conftest import SMALL_PROJ


@pytest.fixture(scope="module")
def proto_stack():
    proj = ProjectorConfig(width=256, height=128)
    stack = np.asarray(jpatterns.pattern_stack(
        proj.width, proj.height, proj.col_bits, proj.row_bits, 200))
    return proj, stack


def _maps(stack_np, cb, rb, ds=1):
    col, row = decode.decode_maps_reference(
        torch.tensor(stack_np)[None], cb, rb, downsample=ds)
    return col[0].numpy(), row[0].numpy()


def test_pattern_stack_matches_jax():
    p = SMALL_PROJ
    for ds in (1, 2):
        ref = np.asarray(jpatterns.pattern_stack(
            p.width, p.height, p.col_bits, p.row_bits, 200, ds))
        got = patterns.pattern_stack(p.width, p.height, p.col_bits,
                                     p.row_bits, 200, ds, device="cpu")
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("crop,ds", [((128, 256), 1), ((97, 250), 1),
                                     ((128, 256), 2), ((97, 161), 2)])
def test_reference_matches_pallas_interpret(proto_stack, crop, ds):
    proj, stack = proto_stack
    s = np.ascontiguousarray(stack[:, :crop[0], :crop[1]])
    col_p, row_p = decode_maps_pallas(jnp.asarray(s), proj.col_bits,
                                      proj.row_bits, downsample=ds,
                                      interpret=True)
    col, row = _maps(s, proj.col_bits, proj.row_bits, ds)
    assert col.shape == crop and col.dtype == np.int32
    assert np.array_equal(col, np.asarray(col_p))
    assert np.array_equal(row, np.asarray(row_p))


def test_reference_matches_xla_on_random_stacks():
    rng = np.random.default_rng(3)
    cb, rb = 5, 4
    stacks = rng.integers(0, 256, (3, 2 + 2 * cb + 2 * rb, 33, 47),
                          dtype=np.uint8)
    col, row = decode.decode_maps_reference(torch.from_numpy(stacks), cb,
                                            rb, downsample=3)
    for b in range(3):
        cj, rj, _ = jdecode.decode_stack(jnp.asarray(stacks[b]), cb, rb,
                                         downsample=3, backend="xla")
        assert np.array_equal(col[b].numpy(), np.asarray(cj))
        assert np.array_equal(row[b].numpy(), np.asarray(rj))


@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_decode_stack_matches_jax_on_synthetic_stop(synth_scan, mode):
    stack, _ = synth_scan
    p = SMALL_PROJ
    cj, rj, mj = jdecode.decode_stack(jnp.asarray(stack), p.col_bits,
                                      p.row_bits, cfg=JDecodeConfig(mode=mode),
                                      backend="xla")
    c, r, m = decode.decode_stack(torch.from_numpy(stack), p.col_bits,
                                  p.row_bits, cfg=DecodeConfig(mode=mode))
    assert np.array_equal(c.numpy(), np.asarray(cj))
    assert np.array_equal(r.numpy(), np.asarray(rj))
    assert np.array_equal(m.numpy(), np.asarray(mj))
    assert 0 < m.numpy().mean() < 1


def test_split_stack_and_decode_bits_match_jax(synth_scan):
    stack, _ = synth_scan
    p = SMALL_PROJ
    parts = decode.split_stack(torch.from_numpy(stack), p.col_bits, p.row_bits)
    jparts = jdecode.split_stack(jnp.asarray(stack), p.col_bits, p.row_bits)
    for a, b in zip(parts, jparts):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for pairs, jpairs in ((parts[2], jparts[2]), (parts[3], jparts[3])):
        code = decode.decode_bits(pairs)
        assert code.dtype == torch.int32
        assert np.array_equal(code.numpy(), np.asarray(
            jdecode.decode_bits(jpairs)))
    with pytest.raises(ValueError, match="frames"):
        decode.split_stack(torch.from_numpy(stack[:-1]), p.col_bits,
                           p.row_bits)


def test_batched_decode_stack_matches_per_stop(synth_scan):
    """A (B, F, H, W) batch decodes (and masks, with per-image thresholds)
    exactly like each stop alone."""
    stack, _ = synth_scan
    p = SMALL_PROJ
    batch = np.stack([stack, stack // 2, np.roll(stack, 7, axis=2)])
    c, r, m = decode.decode_stack(torch.from_numpy(batch), p.col_bits,
                                  p.row_bits)
    for b in range(3):
        cj, rj, mj = jdecode.decode_stack(jnp.asarray(batch[b]), p.col_bits,
                                          p.row_bits, backend="xla")
        assert np.array_equal(c[b].numpy(), np.asarray(cj))
        assert np.array_equal(r[b].numpy(), np.asarray(rj))
        assert np.array_equal(m[b].numpy(), np.asarray(mj))


@pytest.mark.parametrize("shape", [(96, 160), (97, 161), (7, 5), (1, 1)])
@pytest.mark.parametrize("q", [95.0, 50.0, 12.5, 99.9, 0.0, 100.0])
def test_percentile_u8_exact(shape, q):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = float(decode._percentile_u8(torch.from_numpy(x), q))
    assert got == float(jdecode._percentile_u8(jnp.asarray(x), q))
    # numpy's linear percentile on the same data taken as float32.
    assert got == float(np.float32(np.percentile(x.astype(np.float32), q)))


def test_percentile_u8_batched():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (4, 9, 11), dtype=np.uint8)
    got = decode._percentile_u8(torch.from_numpy(x), 95.0).numpy()
    assert got.shape == (4,)
    for b in range(4):
        assert got[b] == float(jdecode._percentile_u8(jnp.asarray(x[b]), 95.0))


def test_decode_maps_wrapper_cpu_takes_reference(proto_stack):
    proj, stack = proto_stack
    before = decode.decode_maps.launches
    t = torch.tensor(stack)[None]
    col, row = decode.decode_maps(t, proj.col_bits, proj.row_bits)
    ref = decode.decode_maps_reference(t, proj.col_bits, proj.row_bits)
    assert torch.equal(col, ref[0]) and torch.equal(row, ref[1])
    assert decode.decode_maps.launches == before   # no kernel on the CPU


def test_decode_maps_rejects_bad_input(proto_stack):
    proj, stack = proto_stack
    t = torch.tensor(stack)
    with pytest.raises(ValueError, match="uint8"):
        decode.decode_maps(t[None].to(torch.int32), proj.col_bits,
                           proj.row_bits)
    with pytest.raises(ValueError, match="uint8"):
        decode.decode_maps(t, proj.col_bits, proj.row_bits)   # not 4-D
    with pytest.raises(ValueError, match="frames"):
        decode.decode_maps(t[None, :-2], proj.col_bits, proj.row_bits)
