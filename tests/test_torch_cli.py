"""The port's CLI (`python -m convopeq_tpu_torch.cli`) against the JAX
package's on the same WAV files, in-process on the CPU: with `--device
cpu --f64` the audio each CLI hands to its WAV writer agrees at <= 1e-9
relative RMS (the JAX engine's chain is jitted, ~4e-11 from the port's),
and the printed latency, auto-gain and loudness lines are the same.
Also: presets across the packages, the bypass paths, `parse_eq_band`,
and the flags --serve and --export-evidence parse."""
import numpy as np
import pytest

from convopeq_tpu import cli as jcli
from convopeq_tpu.utils import wavio as jw
from convopeq_tpu_torch import cli as tcli
from convopeq_tpu_torch.utils import wavio as tw
from convopeq_tpu_torch.utils.dsputil import K_OUTPUT_HEADROOM

SR = 48000


def _fixtures(tmp_path):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 4096)) * 0.2).astype(np.float32)
    ir = (rng.normal(size=2000) * np.exp(-np.arange(2000) / 300.0)
          ).astype(np.float32) * 0.5
    inp, irp = tmp_path / "in.wav", tmp_path / "ir.wav"
    tw.write_wav(str(inp), x, SR)
    tw.write_wav(str(irp), ir[None], SR)
    return inp, irp, x


def _captured(monkeypatch, module):
    """Record what a CLI hands to its WAV writer (before the file's f32
    rounding), still writing the file."""
    got = []
    real = module.write_wav

    def write(path, samples, sample_rate, *a, **k):
        got.append(np.array(samples, np.float64))
        return real(path, samples, sample_rate, *a, **k)
    monkeypatch.setattr(module, "write_wav", write)
    return got


FLAGS = ["--eq", "0:peaking:1000:+6:1.4", "--eq", "3:highshelf:8000:-3:0.7",
         "--softclip", "0.25", "--auto-gain", "--measure"]


def test_cli_matches_jax(tmp_path, capsys, monkeypatch):
    inp, irp, x = _fixtures(tmp_path)
    got_t = _captured(monkeypatch, tw)
    got_j = _captured(monkeypatch, jw)
    assert tcli.main([str(inp), str(tmp_path / "t.wav"), "--ir", str(irp),
                      "--device", "cpu", "--f64"] + FLAGS) == 0
    out_t = capsys.readouterr().out.splitlines()
    assert jcli.main([str(inp), str(tmp_path / "j.wav"), "--ir", str(irp),
                      "--f64"] + FLAGS) == 0
    out_j = capsys.readouterr().out.splitlines()
    yt, yj = got_t[-1], got_j[-1]
    assert yt.shape == yj.shape == x.shape
    err = np.sqrt(np.mean((yt - yj) ** 2) / np.mean(yj ** 2))
    assert err <= 1e-9, err
    for prefix in ("latency:", "auto gain:", "integrated loudness:"):
        lt = [ln for ln in out_t if ln.startswith(prefix)]
        lj = [ln for ln in out_j if ln.startswith(prefix)]
        assert lt == lj and len(lt) == 1, (lt, lj)
    y = tw.read_wav(str(tmp_path / "t.wav"))
    assert y.samples.shape == x.shape and np.isfinite(y.samples).all()
    assert not np.allclose(y.samples, x, atol=1e-4)


def test_cli_presets_round_trip_and_cross_packages(tmp_path, capsys):
    """Settings from a preset (no --eq / --softclip flags) give the same
    output, the preset written by the port's CLI or by the JAX CLI."""
    inp, irp, _ = _fixtures(tmp_path)
    flags = ["--eq", "0:peaking:1000:+6:1.4", "--softclip", "0.25"]
    outs = {}
    for name, main in (("t", tcli.main), ("j", jcli.main)):
        extra = ["--device", "cpu", "--f64"] if name == "t" else ["--f64"]
        assert main([str(inp), str(tmp_path / f"o{name}.wav"), "--ir",
                     str(irp), "--save-state", str(tmp_path / f"{name}.json")]
                    + flags + extra) == 0
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    base = tw.read_wav(str(tmp_path / "ot.wav")).samples
    for name in ("t", "j"):
        out = tmp_path / f"from_{name}.wav"
        assert tcli.main([str(inp), str(out), "--ir", str(irp), "--device",
                          "cpu", "--f64", "--load-state",
                          str(tmp_path / f"{name}.json")]) == 0
        np.testing.assert_array_equal(tw.read_wav(str(out)).samples, base)
    assert "state saved" in capsys.readouterr().out


def test_cli_bypass_paths_and_dither(tmp_path):
    """No --ir and no --eq: both stages bypassed, the output conditioning
    gain-transparent in the passband (tests/test_cli.py's check); with
    --dither the output sits on the 24-bit grid."""
    inp, _, x = _fixtures(tmp_path)
    out = tmp_path / "out.wav"
    assert tcli.main([str(inp), str(out), "--device", "cpu", "--f64"]) == 0
    y = tw.read_wav(str(out)).samples
    X = np.fft.rfft(x, axis=-1) * K_OUTPUT_HEADROOM
    Y = np.fft.rfft(y, axis=-1)
    f = np.fft.rfftfreq(x.shape[-1], 1 / SR)
    band = (f > 300.0) & (f < 15000.0)
    err = np.abs(np.abs(Y[:, band]) - np.abs(X[:, band]))
    assert err.max() < 2e-2 * np.abs(X[:, band]).max()
    out2 = tmp_path / "dith.wav"
    assert tcli.main([str(inp), str(out2), "--device", "cpu",
                      "--dither", "psycho:24"]) == 0
    grid = tw.read_wav(str(out2)).samples * 8388608.0
    np.testing.assert_array_equal(grid, np.round(grid))


def test_parse_eq_band_and_flags():
    assert tcli.parse_eq_band("0:peaking:1000:+6:1.4") == \
        jcli.parse_eq_band("0:peaking:1000:+6:1.4") == \
        (0, 1, 1000.0, 6.0, 1.4, 0)
    assert tcli.parse_eq_band("19:highpass:30:0:0.7:4")[5] == 4
    with pytest.raises(ValueError):
        tcli.parse_eq_band("0:peaking:1000")
    with pytest.raises(KeyError):
        tcli.parse_eq_band("0:notch:1000:+6:1.4")
    assert tcli.main([]) == 0                     # no input: the help
    with pytest.raises(SystemExit):
        tcli.main(["in.wav", "out.wav", "--device", "tpu"])
    # --serve and --export-evidence parse (the JAX CLI's flags): the run
    # then stops at the missing input file
    for flag in (["--serve"], ["--export-evidence", "dir"]):
        with pytest.raises(FileNotFoundError):
            tcli.main(["missing_in.wav", "out.wav", "--device", "cpu"]
                      + flag)
