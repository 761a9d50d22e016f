"""CLI smoke tests (render + info), small resolutions on CPU."""

import os

import numpy as np
import pytest

from voxtracer.cli import main
from voxtracer.io.image import read_png

# minutes-scale on a 2-vCPU box (golden renders, multi-second jit
# compiles): long-lane only, the fast CI gate runs `-m 'not slow'`
# (pyproject.toml marker)
pytestmark = pytest.mark.slow


def test_cli_render_teapot(tmp_path):
    out = str(tmp_path / "teapot.png")
    main(["render", "--preset", "teapot", "--width", "24", "--height", "24",
          "--frames", "1", "--output", out])
    img = read_png(out)
    assert img.shape == (24, 24, 3)
    assert img.std() > 0  # not a constant image


def test_cli_render_glassbox_whitted(tmp_path):
    out = str(tmp_path / "box.png")
    main(["render", "--preset", "glassbox", "--width", "16", "--height", "16",
          "--bounces", "2", "--frames", "2", "--output", out])
    assert os.path.exists(out)


def test_cli_info(capsys):
    main(["info"])
    assert "devices" in capsys.readouterr().out
