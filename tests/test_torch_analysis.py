"""The port's roofline analysis (``repro_torch.analysis``) and the config
methods it reads, against the reference's (``repro.analysis``,
``repro.configs.base``), for every architecture at its published widths,
every input shape and both production meshes. Pure arithmetic: no step
is traced or compiled.

- ``analytic_flops`` (``block_skip`` and ``masked_full``),
  ``cache_bytes``, ``analytic_memory`` (but its ``fits_*`` key, which
  names the card) and ``analytic_hbm_traffic`` equal the reference's
  exactly.
- ``uses_attention``, ``supports_long_context``, ``effective_window`` and
  ``active_param_count`` equal the reference's.
- ``roofline`` on the same dry-run dict: the compute and memory terms are
  the reference's times 197e12 / 989e12 and 819e9 / 3.35e12 (the H100's
  rates for the TPU's); the collective term the reference's times
  ``ici_bw / link_bw / dtype_corr``: the port takes no 0.5 factor for
  bf16 configs, since its dry run's bytes keep their dtypes.
"""
import pytest

pytest.importorskip("jax")
from repro import analysis as JA  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch import analysis as A  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa: E402

ARCHS = list_archs()
CASES = [(a, s) for a in ARCHS for s in INPUT_SHAPES]
# a dry-run record: every collective kind, and traced flops
DRYRUN = {"flops_per_device": 1.5e14,
          "collective_bytes_per_device": {
              "all-gather": 3.0e9, "reduce-scatter": 1.25e9,
              "all-reduce": 7.0e6, "collective-permute": 2.5e5}}


def pair(arch, shape):
    return (get_config(arch), INPUT_SHAPES[shape], jax_get_config(arch),
            JSHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_config_methods_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert c.uses_attention == j.uses_attention
        assert c.supports_long_context() == j.supports_long_context()
        assert c.active_param_count() == j.active_param_count()
        for name in INPUT_SHAPES:
            assert c.effective_window(INPUT_SHAPES[name]) == \
                j.effective_window(JSHAPES[name])


@pytest.mark.parametrize("arch,shape", CASES)
def test_analytic_terms_are_the_references(arch, shape):
    cfg, sh, jcfg, jsh = pair(arch, shape)
    assert A.cache_bytes(cfg, sh) == JA.cache_bytes(jcfg, jsh)
    for multi_pod in (False, True):
        assert A.mesh_shape(multi_pod) == JA.mesh_shape(multi_pod)
        for impl in ("block_skip", "masked_full"):
            assert A.analytic_flops(cfg, sh, multi_pod, impl) == \
                JA.analytic_flops(jcfg, jsh, multi_pod, impl)
        got = A.analytic_memory(cfg, sh, multi_pod)
        want = JA.analytic_memory(jcfg, jsh, multi_pod)
        assert got.pop("fits_80GB") == (got["total"] < A.HW["hbm_cap"])
        want.pop("fits_16GiB")
        assert got == want
        assert A.analytic_hbm_traffic(cfg, sh, multi_pod) == \
            JA.analytic_hbm_traffic(jcfg, jsh, multi_pod)


@pytest.mark.parametrize("arch,shape", CASES)
def test_roofline_takes_the_h100_rates_and_no_dtype_factor(arch, shape):
    cfg, sh, jcfg, jsh = pair(arch, shape)
    for multi_pod in (False, True):
        got = A.roofline(cfg, sh, DRYRUN, multi_pod)
        want = JA.roofline(jcfg, jsh, DRYRUN, multi_pod)
        rel = dict(rel=1e-12, abs=0)
        assert got["compute_s"] == pytest.approx(
            want["compute_s"] * JA.HW["peak_flops"] / A.HW["peak_flops"],
            **rel)
        assert got["memory_s"] == pytest.approx(
            want["memory_s"] * JA.HW["hbm_bw"] / A.HW["hbm_bw"], **rel)
        dtype_corr = 0.5 if jcfg.dtype == "bfloat16" else 1.0
        assert got["collective_s"] == pytest.approx(
            want["collective_s"] * JA.HW["ici_bw"] / A.HW["link_bw"]
            / dtype_corr, **rel)
        assert got["collective_s"] == sum(
            DRYRUN["collective_bytes_per_device"].values()) / 450e9
        for k in ("arch", "shape", "mesh", "model_flops",
                  "analytic_flops_per_device", "useful_ratio",
                  "mem_budget_GiB"):
            assert got[k] == want[k], k
        assert got["fits_80GB"] == \
            A.analytic_memory(cfg, sh, multi_pod)["fits_80GB"]
        assert got["dominant"] == max(
            ("compute", "memory", "collective"), key=lambda t: got[f"{t}_s"])
    assert A.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                    "link_bw": 450e9, "hbm_cap": 85_017_493_504}
