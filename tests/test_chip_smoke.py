"""chip_smoke.py on the CPU at a tiny size: every check of its kernels phase,
its main-path, CPU-parity and four-card phases, and its command-line
contract. On the card the same functions run at the flagship size."""

import json

import pytest

import chip_smoke as cs

# tiny stand-ins for the flagship deployment; W=4 divides the 4-device mesh
TINY = cs.Deployment(
    L=2, beta=0.5, dtau=0.1, W=2, Nrv=2, Nt=2, N_therm=2, N_measurements=2, N_bins=1,
    copy_bytes=1 << 16,
)
TINY4 = cs.Deployment(**{**TINY.__dict__, "W": 4})


@pytest.fixture(scope="module")
def sim():
    return cs.build(TINY)


@pytest.fixture
def rep():
    return cs.Reporter("cpu (test)")


@pytest.mark.parametrize("check", cs.KERNEL_CHECKS, ids=lambda c: c.__name__)
def test_kernel_check(check, sim, rep, capsys):
    check(sim, TINY, rep)
    out = capsys.readouterr().out
    assert "[check]" in out and "FAILED" not in out


def test_kernel_timings_report(sim, rep, capsys):
    cs.kernel_timings(sim, TINY, rep)
    lines = capsys.readouterr().out.splitlines()
    assert any("GB/s" in l and "copy" in l for l in lines)
    assert sum("[time] mul_MtM" in l for l in lines) == 2
    assert sum("[time] CG" in l for l in lines) == 2
    assert all(l.endswith("| cpu (test)") for l in lines)


def test_check_fails_on_missed_tolerance(rep):
    with pytest.raises(cs.CheckFailed):
        rep.check("too far", 1e-3, 1e-5)
    with pytest.raises(cs.CheckFailed):
        rep.check("not a number", float("nan"), 1.0)


def test_main_path_phase(sim, rep, capsys):
    cs.phase_main_path(sim, TINY, rep)
    out = capsys.readouterr().out
    assert "walker-sweeps/s" in out and "memory_analysis" in out
    assert "FAILED" not in out


def test_cpu_parity_phase(sim, rep, capsys):
    cs.phase_cpu_parity(sim, TINY, rep)
    out = capsys.readouterr().out
    for name in ("S_F f64", "density", "double_occ", "equal-time greens"):
        assert name in out
    assert "FAILED" not in out


def test_four_cards_phase_on_virtual_devices(sim, rep, capsys):
    cs.phase_four_cards(sim, TINY4, rep)
    out = capsys.readouterr().out
    assert "x on 4 devices" in out
    assert "accept decisions identical" in out and "FAILED" not in out


def test_four_cards_selects_only_multi_card_phase():
    assert cs.plan(cs.parse_args(["--four-cards"])) == ["device", "four_cards"]
    assert cs.plan(cs.parse_args([])) == ["device", "kernels", "main_path", "cpu_parity"]


def test_main_refuses_a_backend_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_last_line_shape():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == '{"ok": true, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    }
