"""The plain reference against the port's CPU path (its plain versions of
the kernels), on both configurations at a tiny size."""
import pytest
import torch

from portbench import harness


def tiny(cell, **kw):
    mix = harness.traffic(cell)
    mix.update(size=32, iterations=3, pool=2)
    mix.update(kw)
    return mix


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_deconv_ffdnet_reference_matches_the_port():
    case = harness.config("deconv_ffdnet").build(tiny("deconv_ffdnet.512"), 2 ** 31 + 5, "cpu")
    for j in range(2):
        out = case.call(j)
        assert tuple(out.shape) == (1, 3, 32, 32)
        # the same float32 operations in the same order but the divide's:
        # measured 6.6e-7 on this size
        assert harness.compare(out, case.reference(j))["max_abs_err"] <= 5e-6


def test_jdd_ffdnet_reference_matches_the_port_where_well_conditioned():
    # at rho ~ 0.3 two float32 solves agree to rounding; along the real
    # schedule (rho down to 2e-6) CG amplifies rounding
    mix = tiny("jdd_ffdnet.2048", schedule={"kind": "log_descent", "upper": 0.2233,
                                            "lower": 0.2233})
    case = harness.config("jdd_ffdnet").build(mix, 11, "cpu")
    for j in range(2):
        assert harness.compare(case.call(j), case.reference(j))["max_abs_err"] <= 1e-5
    case = harness.config("jdd_ffdnet").build(tiny("jdd_ffdnet.2048", iterations=5), 11, "cpu")
    limits = harness.config("jdd_ffdnet").SPEC["limits"]
    for j in range(2):
        got = harness.compare(case.call(j), case.reference(j), case.observe)
        assert all(got[n] <= v for n, v in limits.items()), got


def test_the_bfloat16_control_departs():
    case = harness.config("jdd_ffdnet").build(tiny("jdd_ffdnet.2048", iterations=5), 11, "cpu")
    limits = harness.config("jdd_ffdnet").SPEC["limits"]
    got = harness.compare(case.reference(0, control=True), case.reference(0), case.observe)
    assert all(got[n] > 3 * v for n, v in limits.items()), got
