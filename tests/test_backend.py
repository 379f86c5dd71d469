"""The one scan-backend choice (models/backend.py).

``auto`` runs the XLA device programs on whatever platform JAX has —
nothing keys on the platform — and ``oracle`` runs the NumPy reference.
Retired or mistyped values are refused with the accepted ones named.
"""

import jax
import numpy as np
import pytest

from mvtrim_tpu.cli import main as cli_main
from mvtrim_tpu.core.config import Config
from mvtrim_tpu.models import MVClusterDetector, SADDetector
from mvtrim_tpu.models.backend import resolve_backend


@pytest.mark.parametrize("requested,resolved", [("auto", "xla"),
                                                ("oracle", "oracle")])
def test_accepted_values(requested, resolved):
    assert resolve_backend(requested) == resolved


@pytest.mark.parametrize("requested", ["pallas", "tpu", "xla", "AUTO", ""])
def test_other_values_rejected(requested):
    with pytest.raises(ValueError, match="accepted values: auto, oracle"):
        resolve_backend(requested)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("detector", [MVClusterDetector, SADDetector])
def test_detectors_route_to_xla_on_every_platform(monkeypatch, platform,
                                                  detector):
    """A detector built while JAX reports a GPU picks the same XLA
    programs as on the CPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    det = detector(640, 480, Config())
    assert det.backend == "xla"


@pytest.mark.parametrize("detector", [MVClusterDetector, SADDetector])
def test_detectors_refuse_retired_backend(detector):
    with pytest.raises(ValueError, match="MVT_SCAN_BACKEND='pallas'"):
        detector(640, 480, Config(scan_backend="pallas"))


def test_cli_rejects_retired_backend(monkeypatch, tmp_path, capsys):
    """The CLI refuses before it opens the input, with the message."""
    monkeypatch.setenv("MVT_SCAN_BACKEND", "pallas")
    rc = cli_main([str(tmp_path / "missing.mp4"), str(tmp_path / "o.mp4")])
    assert rc == 1
    out = capsys.readouterr()
    assert "accepted values: auto, oracle" in out.out + out.err


def test_device_batch_not_rounded():
    """The dispatch batch is the configured size: no tile rounding."""
    for db in (1, 100, 2048):
        assert MVClusterDetector(640, 480,
                                 Config(device_batch=db)).device_batch == db
    det = MVClusterDetector(640, 480, Config(device_batch=100))
    bits = np.zeros((3, det.geom.gh, (det.geom.gw + 7) // 8), np.uint8)
    assert not det.scan_bits(bits).any()
