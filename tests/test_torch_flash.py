"""Port parity for the flash_attn kernel's function.

On the CPU the port's wrapper runs its plain version (full f32 softmax,
GQA by index); these tests hold it against the JAX package's Pallas kernel
in interpret mode over ``tests/test_flash_kernel.py``'s sweep, and against
the JAX oracle and the model's chunked ``flash_attention`` at odd lengths
with GQA, with that file's tolerances (2e-5 f32, 2e-2 bf16). The CUDA
kernel runs only on a card: ``test_cuda_flash_matches_plain_version`` is
marked ``cuda`` and skips without one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.kernels.flash_attn.ref import flash_attention_ref
from repro.models import layers as JL
from repro_torch import kernels as tkernels
from repro_torch.kernels.flash_attn import ops as tops
from repro_torch.kernels.flash_attn import ref as tref
from repro_torch.models import layers as TL
from _jax_caches import fresh_jax_caches  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(t: torch.Tensor, j, dtype: str):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("bh,s,d,qc,kc", [(4, 128, 64, 64, 64),
                                          (2, 256, 32, 128, 64),
                                          (6, 64, 128, 64, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_version_matches_pallas_kernel(bh, s, d, qc, kc, causal,
                                             dtype):
    rng = np.random.default_rng(bh * 1000 + s)
    jq, tq = _pair(rng.normal(size=(bh, s, d)).astype(np.float32), dtype)
    jk, tk = _pair(rng.normal(size=(bh, s, d)).astype(np.float32), dtype)
    jv, tv = _pair(rng.normal(size=(bh, s, d)).astype(np.float32), dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, qc=qc, kc=kc)
    # [BH, S, D] as B = BH rows of one head: the port's [B, S, H, Dh]
    got = tops.flash_attention(tq[:, :, None], tk[:, :, None],
                               tv[:, :, None], causal=causal)
    assert got.dtype == tq.dtype and got.shape == (bh, s, 1, d)
    _close(got[:, :, 0], want, dtype)


@pytest.mark.parametrize("s", [37, 100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gqa_odd_lengths_match_oracle_and_model_flash(s, causal, dtype):
    B, H, KV, Dh = 2, 8, 2, 32
    g = H // KV
    rng = np.random.default_rng(s)
    jq, tq = _pair(rng.normal(size=(B, s, H, Dh)).astype(np.float32), dtype)
    jk, tk = _pair(rng.normal(size=(B, s, KV, Dh)).astype(np.float32), dtype)
    jv, tv = _pair(rng.normal(size=(B, s, KV, Dh)).astype(np.float32), dtype)
    got = TL.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    # the model's chunked attention (gcd chunks of the odd length)
    _close(got, JL.flash_attention(jq, jk, jv, causal=causal, q_chunk=16,
                                   k_chunk=16), dtype)

    # the oracle on the MHA layout, KV heads repeated g times
    def mha(x):
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(-1, s, Dh)

    want = flash_attention_ref(mha(jq), mha(jnp.repeat(jk, g, axis=2)),
                               mha(jnp.repeat(jv, g, axis=2)), causal=causal)
    want = jnp.transpose(want.reshape(B, H, s, Dh), (0, 2, 1, 3))
    _close(got, want, dtype)


def test_scale_argument_matches_oracle():
    rng = np.random.default_rng(5)
    jq, tq = _pair(rng.normal(size=(3, 24, 16)).astype(np.float32), "f32")
    jk, tk = _pair(rng.normal(size=(3, 24, 16)).astype(np.float32), "f32")
    jv, tv = _pair(rng.normal(size=(3, 24, 16)).astype(np.float32), "f32")
    want = flash_attention_ref(jq, jk, jv, causal=True, scale=0.3)
    got = tref.flash_attention_ref(tq[:, :, None], tk[:, :, None],
                                   tv[:, :, None], causal=True, scale=0.3)
    _close(got[:, :, 0], want, "f32")


def _tf32(x: np.ndarray) -> np.ndarray:
    """f32 to TF32, round to nearest with ties away (``cvt.rna.tf32.f32``):
    ``(bits + 0x1000) & ~0x1FFF`` on the int32 view."""
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((b + 0x1000) & ~0x1FFF).view(np.float32)


def _mm_tf32(a: np.ndarray, b: np.ndarray, split: bool) -> np.ndarray:
    """a @ b with TF32 operands and f32 sums, as the tensor cores take it:
    one product, or the 3xTF32 split small*big + big*small + big*big."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return ab @ bb
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def _attention_tf32(q, k, v, split: bool) -> np.ndarray:
    """Causal GQA attention of q ``[S,H,Dh]``, k/v ``[S,KV,Dh]`` (f32) with
    both products in TF32: the arithmetic of csrc/flash_attn.cu."""
    s_len, h, d = q.shape
    g = h // k.shape[1]
    out = np.empty_like(q)
    mask = np.tril(np.ones((s_len, s_len), bool))
    for i in range(h):
        sc = _mm_tf32(q[:, i], k[:, i // g].T, split) * np.float32(
            1 / np.sqrt(d))
        sc = np.where(mask, sc, np.float32(-1e30))
        p = np.exp(sc - sc.max(axis=1, keepdims=True))
        p = (p / p.sum(axis=1, keepdims=True)).astype(np.float32)
        out[:, i] = _mm_tf32(p, v[:, i // g], split)
    return out


def test_3xtf32_split_keeps_f32_tolerance():
    """The Hopper kernel's precision, emulated on the CPU at the serving
    head shapes: the 3xTF32 split stays within the f32 tolerance of the
    plain version, and one TF32 product does not (why the split is
    needed)."""
    rng = np.random.default_rng(0)
    s, h, kv, dh = 256, 12, 2, 128
    q = rng.normal(size=(s, h, dh)).astype(np.float32)
    k = rng.normal(size=(s, kv, dh)).astype(np.float32)
    v = rng.normal(size=(s, kv, dh)).astype(np.float32)
    want = tref.flash_attention_ref(*(torch.from_numpy(x)[None]
                                      for x in (q, k, v)))[0].numpy()
    tol = DTYPES["f32"][2]
    err_split = np.abs(_attention_tf32(q, k, v, True) - want).max()
    err_one = np.abs(_attention_tf32(q, k, v, False) - want).max()
    assert err_split <= tol, err_split
    assert err_one > tol, err_one


def test_cpu_tensors_run_the_plain_version():
    q = torch.randn(1, 40, 4, 16)
    k = torch.randn(1, 40, 2, 16)
    before = dict(tkernels.LAUNCHES)
    out = tops.flash_attention(q, k, k, causal=True)
    assert tkernels.LAUNCHES == before
    torch.testing.assert_close(
        out, tref.flash_attention_ref(q, k, k, causal=True), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_flash_matches_plain_version():
    """The CUDA kernel against its plain version on the card (needs nvcc
    and a CUDA device): the serving path's head shape at a partial tile,
    bf16, non-causal, and the shapes it refuses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for s, dtype, causal, tol in [(100, torch.float32, True, 2e-5),
                                  (100, torch.bfloat16, True, 2e-2),
                                  (70, torch.float32, False, 2e-5)]:
        q = torch.randn(2, s, 12, 128, device="cuda", generator=gen)
        k = torch.randn(2, s, 2, 128, device="cuda", generator=gen)
        v = torch.randn(2, s, 2, 128, device="cuda", generator=gen)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        before = tkernels.LAUNCHES["flash_attn"]
        out = tops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert tkernels.LAUNCHES["flash_attn"] == before + 1
        torch.testing.assert_close(
            out.float(), tref.flash_attention_ref(q, k, v,
                                                  causal=causal).float(),
            rtol=tol, atol=tol)
    q = torch.randn(1, 8, 4, 48, device="cuda")
    with pytest.raises(NotImplementedError):
        tops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(NotImplementedError):
        tops.flash_attention(q[..., :32], q[:, :4, :2, :32],
                             q[:, :4, :2, :32])
