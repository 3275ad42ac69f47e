"""The port's flash-attention wrapper against the reference's Pallas one.

On the CPU the wrapper takes its plain PyTorch version, so these tests
hold the port's arithmetic, layouts, GQA head mapping, masks and errors
against the reference's ``kernels/flash_attention.py`` run the way the
reference's own tests run it (Pallas in interpret mode).  The same
numpy inputs go to both.  The CUDA kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import flash_attention_bhsd as ref_bhsd
from repro.kernels.ref import flash_attention_ref as ref_oracle
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bhsd)
from repro_torch.kernels.ref import flash_attention_ref

torch.set_num_threads(1)

# test_kernels.py's FLASH_CASES: (B, Sq, Sk, H, Hkv, D, causal)
FLASH_CASES = [
    (2, 256, 256, 4, 4, 64, True),     # MHA causal, aligned
    (1, 200, 200, 4, 2, 32, True),     # GQA, ragged (padding path)
    (2, 128, 384, 8, 2, 64, False),    # cross-attn shape, GQA 4x
    (1, 130, 130, 2, 1, 16, True),     # MQA, tiny head dim
    (1, 64, 64, 1, 1, 128, True),      # single head, single block
]


def _qkv(rng, b, sq, sk, h, hkv, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal", FLASH_CASES)
def test_flash_attention_vs_reference_pallas(B, Sq, Sk, H, Hkv, D, causal):
    """Twin of test_flash_attention_vs_oracle, f32 at 2e-5."""
    q, k, v = _qkv(np.random.default_rng(B * 31 + Sq), B, Sq, Sk, H, Hkv, D)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=64,
                                block_k=64, interpret=True))
    got = flash_attention(*_t(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16():
    """Twin of test_flash_attention_bf16: bf16 in and out, 5e-2."""
    q, k, v = _qkv(np.random.default_rng(5), 1, 128, 128, 4, 4, 64)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(ref_flash(bf(q), bf(k), bf(v), causal=True,
                                block_q=64, block_k=64, interpret=True),
                      np.float32)
    got = flash_attention(*_t(q, k, v, dtype=torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


def test_flash_attention_block_shape_independence():
    """Twin of test_flash_attention_block_shape_independence (1e-5): the
    port's answer (its k-block is fixed) is the reference's at every
    block shape the reference's test runs."""
    q, k, v = _qkv(np.random.default_rng(6), 1, 192, 192, 2, 2, 32)
    got = flash_attention(*_t(q, k, v), causal=True).numpy()
    for bq, bk in [(64, 64), (64, 128), (192, 64)]:
        want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, block_q=bq,
                                    block_k=bk, interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,sk", [(40, 100), (100, 40)])
def test_causal_mask_is_top_left_aligned(sq, sk):
    """With Sq != Sk the causal mask keeps kpos <= qpos (top-left), as the
    reference's kernel and oracle do — not the bottom-right alignment of
    a decode-style mask."""
    q, k, v = _qkv(np.random.default_rng(sq + sk), 1, sq, sk, 2, 1, 16)
    want = np.asarray(ref_oracle(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True))
    got = flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # row 0 sees key 0 only: its output is v[0] exactly
    np.testing.assert_allclose(got[0, 0].numpy(),
                               np.repeat(v[0, 0], 2, axis=0),
                               rtol=1e-6, atol=1e-6)


def test_bhsd_layout_maps_heads_like_the_reference():
    """flash_attention_bhsd: q (BH, Sq, D), k/v (BHkv, Sk, D); row b reads
    kv row b // (BH / BHkv).  Against the reference's bhsd kernel, and
    against attending to the mapped kv row alone."""
    rng = np.random.default_rng(11)
    bh, bhkv, s, d = 6, 2, 70, 32
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    k = rng.standard_normal((bhkv, s, d)).astype(np.float32)
    v = rng.standard_normal((bhkv, s, d)).astype(np.float32)
    want = np.asarray(ref_bhsd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, block_q=64,
                               block_k=64, interpret=True))
    got = flash_attention_bhsd(*_t(q, k, v), causal=True)
    assert tuple(got.shape) == (bh, s, d) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    tq, tk, tv = _t(q, k, v)
    for b in range(bh):
        one = flash_attention(tq[b][None, :, None], tk[b // 3][None, :, None],
                              tv[b // 3][None, :, None], causal=True)
        np.testing.assert_allclose(got[b].numpy(), one[0, :, 0].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_strided_heads_are_read_in_place():
    """The (B, S, H, D) wrapper takes any strides with a contiguous last
    axis (the kernel reads them in place): a head-major tensor seen as
    (B, S, H, D) gives the same answer as its contiguous copy."""
    q, k, v = _qkv(np.random.default_rng(12), 2, 50, 50, 4, 2, 16)
    tq, tk, tv = _t(q, k, v)
    hm = lambda x: x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    got = flash_attention(hm(tq), hm(tk), hm(tv))
    want = flash_attention(tq, tk, tv)
    assert not hm(tq).is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_version_is_the_reference_oracle():
    """flash_attention_ref is the reference's flash_attention_ref."""
    q, k, v = _qkv(np.random.default_rng(13), 2, 33, 33, 4, 2, 8)
    for causal in (True, False):
        want = np.asarray(ref_oracle(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal))
        got = flash_attention_ref(*_t(q, k, v), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_wrapper_raises_instead_of_falling_back():
    """Shapes, types and devices the kernel does not take raise on every
    device; a device with no kernel raises; plain-version calls never
    count a launch."""
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 2, 16))
    before = kfa.LAUNCHES
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.zeros((1, 8, 4, 24)), torch.zeros((1, 8, 2, 24)),
                        torch.zeros((1, 8, 2, 24)))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(torch.zeros((1, 8, 3, 16)), kv, kv)
    with pytest.raises(ValueError, match="unsupported dtype"):
        flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="dtypes differ"):
        flash_attention(q, kv.half(), kv.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(torch.zeros((1, 8, 4, 32))[..., ::2], kv, kv)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    out = flash_attention(q, kv, kv)
    assert tuple(out.shape) == (1, 8, 4, 16)
    assert kfa.LAUNCHES == before


def test_compiled_blocks_fit_shared_memory():
    """Every compiled (path, head dim) fits the shared memory one block
    may use on the card.  simt stages f32 (113 KB at D = 128); mma stages
    the input type, the q tile and two K/V stages (85 KB at D = 128, so
    two blocks share an SM)."""
    for path in kfa.PATHS:
        for d in kfa.HEAD_DIMS:
            assert kfa.smem_bytes(path, d) <= kfa.SMEM_BUDGET, (path, d)
    assert kfa.BLOCKS == {"simt": (64, 64), "mma": (64, 64)}
    assert kfa.smem_bytes("simt", 128) == 115968
    assert kfa.smem_bytes("mma", 128) == 87040
    assert 2 * kfa.smem_bytes("mma", 128) <= kfa.SMEM_BUDGET
    with pytest.raises(ValueError, match="unknown path"):
        kfa.smem_bytes("wgmma", 128)


def test_compiled_tables_match_the_source():
    """The wrapper's head dims, blocks and path codes are what
    ``csrc/flash_attention.cu`` instantiates: a head dim or block asked
    of the library that it did not compile would fail only on the card."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    dims = re.search(r"#define FLASH_HEAD_DIMS\(X\) (.*)", src).group(1)
    assert tuple(map(int, re.findall(r"X\((\d+)\)", dims))) == kfa.HEAD_DIMS
    for path in kfa.PATHS:
        line = re.search(rf"#define FLASH_{path.upper()}_BLOCKS\(X\) (.*)",
                         src)
        assert line, path
        blocks = [(int(a), int(b)) for a, b in
                  re.findall(r"X\((\d+), (\d+)\)", line.group(1))]
        assert blocks == [kfa.BLOCKS[path]], path
        assert re.search(rf"FLASH_{path.upper()}_BLOCKS\(FLASH_"
                         rf"{path.upper()}_CASE\)", src), path
    codes = {name.lower(): int(code)
             for name, code in re.findall(r"kPath(\w+) = (\d)", src)}
    assert codes == kfa.PATH_CODES


def _bshd(dtype, b=2, s=24, h=4, d=16, pad=0, offset=0):
    """A (B, S, H, D) view of ``dtype`` whose seq stride is H*D + pad and
    whose base sits ``offset`` elements into its storage."""
    n = b * s * (h * d + pad)
    flat = torch.zeros(n + offset, dtype=dtype)[offset:]
    return flat.view(b, s, h * d + pad)[..., :h * d].unflatten(-1, (h, d))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", kfa.HEAD_DIMS)
def test_flash_path_takes_mma_for_aligned_16_bit_operands(dtype, d):
    """Contiguous f16/bf16 operands, the bhsd layout's permuted views and
    a size-1 axis of any stride take the tensor-core path at every
    compiled head dim."""
    q, kv = _bshd(dtype, d=d), _bshd(dtype, h=2, d=d)
    assert kfa.flash_path(dtype, d, q, kv, kv) == "mma"
    bhsd = torch.zeros((6, 40, d), dtype=dtype).permute(1, 0, 2)[None]
    assert kfa.flash_path(dtype, d, bhsd) == "mma"
    one = torch.zeros((1, 1, 4, d), dtype=dtype)
    assert kfa.flash_path(dtype, d, one.as_strided(one.shape,
                                                   (3, 5, d, 1))) == "mma"


def test_flash_path_takes_simt_where_mma_cannot_read():
    """f32 at any layout, a 16-bit seq stride off a multiple of 8
    elements and a 16-bit base off 16 bytes (a view one element in) all
    take the CUDA-core path."""
    assert kfa.flash_path(torch.float32, 128, _bshd(torch.float32)) == "simt"
    for dtype in (torch.bfloat16, torch.float16):
        aligned = _bshd(dtype)
        assert kfa.flash_path(dtype, 16, aligned) == "mma"
        ragged = _bshd(dtype, pad=1)
        assert ragged.stride(1) % 8 and ragged.stride(-1) == 1
        assert kfa.flash_path(dtype, 16, aligned, ragged) == "simt"
        shifted = _bshd(dtype, offset=1)
        assert shifted.data_ptr() % 16
        assert kfa.flash_path(dtype, 16, shifted, aligned) == "simt"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_cpu_calls_never_count_a_launch(dtype):
    """The plain version runs for CPU tensors on either path and counts
    nothing: not in all, by dtype or by path."""
    q, kv = _bshd(dtype), _bshd(dtype, h=2)
    before = (kfa.LAUNCHES, dict(kfa.LAUNCHES_BY_DTYPE),
              {p: dict(n) for p, n in kfa.LAUNCHES_BY_PATH.items()})
    flash_attention(q, kv, kv)
    flash_attention_bhsd(q[0].transpose(0, 1), kv[0].transpose(0, 1),
                         kv[0].transpose(0, 1))
    assert (kfa.LAUNCHES, kfa.LAUNCHES_BY_DTYPE, kfa.LAUNCHES_BY_PATH) \
        == before
