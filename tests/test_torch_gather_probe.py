"""The gather probe of the port (P1-P3) against the JAX package's:
each plain version bit-equal to its Pallas body run in interpret mode,
the torch one-hot forms bit-equal to the script's jnp forms, the
wrappers' checks on the CPU, and the probe's entry point. Inputs are
made from numpy seeds, as ``scripts/probe_gather.py`` makes them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pagerank_tpu_torch.ops import gather_probe as gp
from pagerank_tpu_torch.scripts import probe_gather as pg

REPO = Path(__file__).resolve().parent.parent
ROWS, N, CHUNK = 1024, 4096, 512
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(dtype_name, rows=ROWS, n=N, seed=0):
    """(numpy z, src, w in the JAX dtype; torch z, src, w) from the
    script's draws (``scripts/probe_gather.py:51-54``)."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, (rows, 128)).astype(np.int32)
    w = rng.random((rows, 128), np.float32).astype(jdt)
    z = rng.random(n, np.float32).astype(jdt)
    return (z, src, w), pg.make_inputs(rows, n, tdt, seed, "cpu")


def _bits(a):
    """A JAX or torch array as float32 numpy (exact for f32 and bf16)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


# -- the Pallas bodies, copied from scripts/probe_gather.py -----------------
# That script defines them inside main(), so they cannot be imported.
# The pallas_call spec is :148-160 and the bodies :169-190, verbatim.


def _pallas(kernel_body, z, src, w):
    rows, dtype = src.shape[0], w.dtype
    f = pl.pallas_call(
        kernel_body,
        out_shape=jax.ShapeDtypeStruct((rows, 128), dtype),
        grid=(rows // CHUNK,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.VMEM),  # z, whole, resident
            pl.BlockSpec((CHUNK, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((CHUNK, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(
            (CHUNK, 128), lambda i: (i, 0), memory_space=pltpu.VMEM
        ),
        interpret=True,
    )
    return jax.jit(f)(jnp.asarray(z), jnp.asarray(src), jnp.asarray(w))


def k_take(z_ref, s_ref, w_ref, o_ref):
    o_ref[:] = z_ref[...][s_ref[...]] * w_ref[...]


def k_onehot8(z_ref, s_ref, w_ref, o_ref):
    zw = z_ref[...].reshape(-1, 8)
    s = s_ref[...]
    rows_g = zw[s >> 3]
    sel = jax.nn.one_hot(s & 7, 8, dtype=zw.dtype)
    o_ref[:] = (rows_g * sel).sum(-1) * w_ref[...]


def k_taa(z_ref, s_ref, w_ref, o_ref):
    # take_along_axis within 128 lanes after a row gather
    zw = z_ref[...].reshape(-1, 128)
    s = s_ref[...]
    rows_g = zw[s >> 7]  # (CHUNK,128,128) gather - likely unsupported
    o_ref[:] = jnp.take_along_axis(
        rows_g, (s & 127)[..., None], axis=-1
    )[..., 0] * w_ref[...]


# -- the script's XLA forms, copied likewise (:62-66, :68-79, :126-131) -----


def take1d(z, s, w):
    return z[s] * w


def make_onehot(width):
    shift = width.bit_length() - 1
    mask = width - 1

    def f(z, s, w):
        zw = z.reshape(-1, width)
        rows_g = zw[s >> shift]
        sel = jax.nn.one_hot(s & mask, width, dtype=z.dtype)
        return (rows_g * sel).sum(-1) * w

    return f


def onehot128mxu(z, s, w):
    zw = z.reshape(-1, 128)
    rows_g = zw[s >> 7]  # (rows, 128, 128)
    sel = jax.nn.one_hot(s & 127, 128, dtype=z.dtype)
    return jnp.einsum("rlk,rlk->rl", rows_g, sel) * w


PLAIN = {
    "k_take": (k_take, gp.gather_take_reference, gp.gather_take,
               "gather_take"),
    "k_onehot8": (k_onehot8, gp.gather_group_reference, gp.gather_group8,
                  "gather_group8"),
    "k_taa": (k_taa, gp.gather_rowsel_reference, gp.gather_rowsel,
              "gather_rowsel"),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("body", sorted(PLAIN))
def test_plain_version_bit_equal_to_interpret_pallas(body, dtype):
    (jz, jsrc, jw), (z, src, w) = _inputs(dtype)
    kernel_body, reference, wrapper, counter = PLAIN[body]
    want = _pallas(kernel_body, jz, jsrc, jw)
    got = reference(z, src, w)
    assert got.dtype == z.dtype and got.shape == (ROWS, 128)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # On the CPU the wrapper takes its plain version and launches nothing.
    before = dict(gp.launches)
    assert torch.equal(wrapper(z, src, w), got)
    assert gp.launches == before and gp.launches[counter] == before[counter]


XLA_FORMS = {"take1d": (jax.jit(take1d), "take1d"),
             "onehot8": (jax.jit(make_onehot(8)), "onehot8"),
             "onehot16": (jax.jit(make_onehot(16)), "onehot16"),
             "onehot32": (jax.jit(make_onehot(32)), "onehot32"),
             "onehot128mxu": (jax.jit(onehot128mxu), "onehot128mxu")}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", sorted(XLA_FORMS))
def test_torch_forms_bit_equal_to_the_scripts_jnp_forms(form, dtype):
    (jz, jsrc, jw), (z, src, w) = _inputs(dtype, rows=256, seed=4)
    jfn, name = XLA_FORMS[form]
    want = jfn(jnp.asarray(jz), jnp.asarray(jsrc), jnp.asarray(jw))
    np.testing.assert_array_equal(_bits(pg.FORMS[name](z, src, w)),
                                  _bits(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_inputs_are_the_scripts_draws(dtype):
    (jz, jsrc, jw), (z, src, w) = _inputs(dtype, rows=64, n=1000, seed=7)
    np.testing.assert_array_equal(src.numpy(), jsrc)
    np.testing.assert_array_equal(_bits(z), _bits(jz))
    np.testing.assert_array_equal(_bits(w), _bits(jw))
    assert z.dtype == w.dtype == DTYPES[dtype][1]


@pytest.mark.parametrize("width", [8, 16, 32, 128])
def test_plain_versions_chunk_rows_without_changing_the_result(monkeypatch,
                                                               width):
    """A row loop of 3-row chunks gives the unchunked result."""
    _, (z, src, w) = _inputs("float32", rows=40, seed=5)
    ref = (gp.gather_rowsel_reference if width == 128 else
           lambda z, s, w: gp.gather_group_reference(z, s, w, width))
    whole = ref(z, src, w)
    monkeypatch.setattr(gp, "_CHUNK_BYTES", 3 * 128 * width * 4)
    assert len(list(gp._row_chunks(40, width, 4))) == 14
    assert torch.equal(ref(z, src, w), whole)
    assert torch.equal(whole, z[src.long()] * w)


# -- the wrappers' checks ---------------------------------------------------

WRAPPERS = {"gather_take": gp.gather_take, "gather_group8": gp.gather_group8,
            "gather_rowsel": gp.gather_rowsel}


def _bad_inputs(case):
    _, (z, src, w) = _inputs("float32", rows=8, seed=1)
    if case == "z_float64":
        return z.double(), src, w.double(), TypeError
    if case == "w_dtype_mismatch":
        return z, src, w.to(torch.bfloat16), TypeError
    if case == "src_int64":
        return z, src.long(), w, TypeError
    if case == "src_not_128_wide":
        return z, src[:, :64].contiguous(), w[:, :64].contiguous(), ValueError
    if case == "w_shape":
        return z, src, w[:4], ValueError
    if case == "z_2d":
        return z.view(-1, 8), src, w, ValueError
    if case == "src_not_contiguous":
        return z, src.t().contiguous().t(), w, ValueError
    if case == "w_not_contiguous":
        return z, src, w.t().contiguous().t(), ValueError
    if case == "devices_differ":
        return z.to("meta"), src, w, ValueError
    if case == "not_cuda_or_cpu":
        return z.to("meta"), src.to("meta"), w.to("meta"), ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "z_float64", "w_dtype_mismatch", "src_int64", "src_not_128_wide",
    "w_shape", "z_2d", "src_not_contiguous", "w_not_contiguous",
    "devices_differ", "not_cuda_or_cpu"])
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_wrappers_raise_on_what_the_kernels_do_not_take(kernel, case):
    z, src, w, err = _bad_inputs(case)
    before = dict(gp.launches)
    with pytest.raises(err):
        WRAPPERS[kernel](z, src, w)
    assert gp.launches == before


def test_group8_needs_n_a_multiple_of_8():
    _, (z, src, w) = _inputs("float32", rows=8, n=4100, seed=2)
    with pytest.raises(ValueError, match="multiple of 8"):
        gp.gather_group8(z, src, w)
    assert gp.gather_take(z, src, w).shape == (8, 128)


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 58_112),
                                         (torch.bfloat16, 116_224)])
def test_rowsel_fits_the_shared_memory_of_a_block(dtype, limit):
    assert gp.rowsel_fits(limit, dtype)
    assert not gp.rowsel_fits(limit + 1, dtype)
    assert limit * dtype.itemsize <= gp.SMEM_LIMIT == 232_448
    src = torch.full((2, 128), limit - 1, dtype=torch.int32)
    w = torch.full((2, 128), 0.5, dtype=dtype)
    z = torch.arange(limit).to(dtype)
    assert torch.equal(gp.gather_rowsel(z, src, w), z[-1] * w)
    z = torch.zeros(limit + 128, dtype=dtype)
    with pytest.raises(ValueError, match="232448 bytes"):
        gp.gather_rowsel(z, src, w)
    with pytest.raises(ValueError, match="multiple of 128"):
        gp.gather_rowsel(torch.zeros(1000, dtype=dtype), src, w)


def test_bound_bytes():
    """The probe's byte bound, now the registry's cost model, with the
    device table's memory rate."""
    from pagerank_tpu_torch.analysis.kernels import probe_cost
    from pagerank_tpu_torch.obs import costs

    assert probe_cost(1 << 19, 1 << 22, 4)["bytes"] == 822_083_584
    rate = costs.device_spec("NVIDIA H100 80GB HBM3").hbm_bytes_per_s
    assert round(822_083_584 / rate * 1e3, 4) == 0.2454
    assert probe_cost(1 << 19, 1 << 22, 2)["bytes"] == (
        (1 << 19) * 128 * 8 + (1 << 22) * 2)
    assert probe_cost(10, 0, 4)["bytes"] == 10 * 128 * 12


def test_skip_reasons_follow_the_geometry():
    f32, bf16 = torch.float32, torch.bfloat16
    assert pg.skip_reason("probe_take", 4100, f32) is None
    assert pg.skip_reason("probe_group8", 4100, f32) == (
        "SKIP width does not divide n")
    assert pg.skip_reason("onehot32", 4112, f32) == (
        "SKIP width does not divide n")
    assert pg.skip_reason("onehot16", 4112, f32) is None
    assert pg.skip_reason("probe_rowsel_smem", 1 << 15, bf16) is None
    assert pg.skip_reason("probe_rowsel_smem", 1 << 16, bf16) is None
    assert pg.skip_reason("probe_rowsel_smem", 1 << 16, f32).startswith(
        "SKIP z takes 262144 B")
    assert pg.skip_reason("onehot128mxu", 1 << 20, f32) is None


def test_run_probe_times_what_applies_and_skips_the_rest():
    _, (z, src, w) = _inputs("bfloat16", rows=16, n=4104, seed=3)
    res = pg.run_probe(z, src, w, iters=1)
    assert list(res) == list(pg.FORMS)
    assert all(isinstance(res[k], float) and res[k] > 0
               for k in ("take1d", "onehot8", "probe_take", "probe_group8"))
    assert res["onehot16"] == res["probe_rowsel_smem"] == (
        "SKIP width does not divide n")
    assert pg.run_probe(z, src, w, iters=1, forms=["take1d"]).keys() == {
        "take1d"}


# -- the entry point --------------------------------------------------------


def _run_script(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, "-m", "pagerank_tpu_torch.scripts.probe_gather",
         *args], capture_output=True, text=True, env=env, timeout=300,
        cwd=str(REPO))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_point_on_the_cpu(dtype):
    r = _run_script("--device", "cpu", "--rows", "1024", "--n", "4096",
                    "--iters", "2", "--dtype", dtype)
    assert r.returncode == 0, r.stderr[-800:]
    lines = r.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["rows"] == 1024 and rec["n"] == 4096
    assert rec["dtype"] == dtype and rec["device"] == "cpu"
    assert rec["bound_ms"] is None
    for form in pg.FORMS:
        assert isinstance(rec["forms"][form], float)
        assert any(ln.split()[:1] == [form] and "Gslot/s" in ln
                   for ln in lines), form


def test_entry_point_without_a_card_names_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device runs")
    r = _run_script("--rows", "8", "--n", "64")
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    assert "Gslot/s" not in r.stdout
