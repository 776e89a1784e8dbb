"""GPU lane: every 2D and 3D family and the streamed image-quality path
execute on the card in production f32 (every matmul, einsum and convolution
at HIGHEST precision) and are compared against a CPU float64 run of the SAME
engine at the shared f32 tiers of nyxus_tpu.parity.

Run on a machine with a GPU:  python -m pytest tests/ -m gpu -q

The CPU-f64 expectation is computed in a subprocess (pinned to
JAX_PLATFORMS=cpu) so it can never go stale against the committed engine and
never takes the card.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from nyxus_tpu import parity

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _expected_cpu(script: str, out_csv: str):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, "-c", script], check=True, env=env,
                   cwd=ROOT, timeout=2400)
    return pd.read_csv(out_csv)


@pytest.mark.gpu
def test_all_2d_families_on_device(tmp_path, gpu_device):
    from conftest import make_blobs
    from nyxus_tpu import columns as col
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner import PairRunner

    intens, labels = make_blobs(n_blobs=8, seed=3)
    fset = tx.parse_feature_request(["*ALL*"])
    runner = PairRunner(fset, EngineConfig(precision="f32"))
    labs, vals = runner.run(intens, labels)
    hdr, _ = col.build_header(fset, EngineConfig())
    dev = pd.DataFrame(vals, columns=hdr[4:])
    dev["ROI_label"] = labs

    out_csv = str(tmp_path / "cpu64.csv")
    script = (
        "import sys, os\n"
        "sys.path[:0] = [%r, %r]\n"
        "import jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import pandas as pd\n"
        "from conftest import make_blobs\n"
        "from nyxus_tpu import columns as col\n"
        "from nyxus_tpu import taxonomy as tx\n"
        "from nyxus_tpu.config import EngineConfig\n"
        "from nyxus_tpu.pipeline.runner import PairRunner\n"
        "intens, labels = make_blobs(n_blobs=8, seed=3)\n"
        "fset = tx.parse_feature_request(['*ALL*'])\n"
        "runner = PairRunner(fset, EngineConfig(precision='f64'))\n"
        "labs, vals = runner.run(intens, labels)\n"
        "hdr, _ = col.build_header(fset, EngineConfig())\n"
        "df = pd.DataFrame(vals, columns=hdr[4:])\n"
        "df['ROI_label'] = labs\n"
        "df.to_csv(%r, index=False)\n"
    ) % (ROOT, HERE, out_csv)
    ref = _expected_cpu(script, out_csv)

    res = parity.compare_f32(dev.set_index("ROI_label"),
                             ref.set_index("ROI_label"))
    assert res.ok, ("f32-on-device beyond tolerance vs f64 CPU: %r"
                    % res.failures[:30])


@pytest.mark.gpu
def test_3d_families_on_device(tmp_path, gpu_device):
    from conftest import make_blobs3d
    from nyxus_tpu import columns as col
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner3d import VolumeRunner

    intens, labels = make_blobs3d()
    fset = tx.parse_feature_request(["*3D_ALL*"], dim=3)
    runner = VolumeRunner(fset, EngineConfig(precision="f32"))
    labs, vals = runner.run(intens, labels.astype(np.int32))
    hdr, _ = col.build_header(fset, EngineConfig())
    dev = pd.DataFrame(vals, columns=hdr[4:])
    dev["ROI_label"] = labs

    out_csv = str(tmp_path / "cpu64_3d.csv")
    script = (
        "import sys, os\n"
        "sys.path[:0] = [%r, %r]\n"
        "import jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import numpy as np\n"
        "import pandas as pd\n"
        "from conftest import make_blobs3d\n"
        "from nyxus_tpu import columns as col\n"
        "from nyxus_tpu import taxonomy as tx\n"
        "from nyxus_tpu.config import EngineConfig\n"
        "from nyxus_tpu.pipeline.runner3d import VolumeRunner\n"
        "intens, labels = make_blobs3d()\n"
        "fset = tx.parse_feature_request(['*3D_ALL*'], dim=3)\n"
        "runner = VolumeRunner(fset, EngineConfig(precision='f64'))\n"
        "labs, vals = runner.run(intens, labels.astype(np.int32))\n"
        "hdr, _ = col.build_header(fset, EngineConfig())\n"
        "df = pd.DataFrame(vals, columns=hdr[4:])\n"
        "df['ROI_label'] = labs\n"
        "df.to_csv(%r, index=False)\n"
    ) % (ROOT, HERE, out_csv)
    ref = _expected_cpu(script, out_csv)

    res = parity.compare_f32(dev.set_index("ROI_label"),
                             ref.set_index("ROI_label"))
    assert res.ok, ("3D f32-on-device beyond tolerance vs f64 CPU: %r"
                    % res.failures[:30])


@pytest.mark.gpu
def test_imq_families_on_device(tmp_path, gpu_device):
    """All four IMQ families (6 features) at f32, streamed (ram_limit=1),
    vs the in-memory path at f64 on CPU.  In-memory IMQ is host numpy at
    f64 whatever the precision, so only the streamed path reaches the card:
    its power spectrum is a c64 FFT there.  Per-column assertions:
    FOCUS_SCORE, LOCAL_FOCUS_SCORE, POWER_SPECTRUM_SLOPE, MIN_SATURATION,
    MAX_SATURATION, SHARPNESS (reference: focus_score.h:12-30,
    power_spectrum.h, saturation.h, sharpness.h)."""
    from nyxus_tpu import ImageQuality

    r = np.random.default_rng(21)
    img = r.integers(0, 4000, (96, 112)).astype(np.uint16)
    lab = np.zeros(img.shape, np.int32)
    lab[4:44, 6:60] = 1
    lab[50:90, 20:100] = 2
    dev = ImageQuality(precision="f32", ram_limit=1).featurize(img, lab)

    out_csv = str(tmp_path / "imq_cpu64.csv")
    script = (
        "import sys\n"
        "sys.path[:0] = [%r, %r]\n"
        "import jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import numpy as np\n"
        "from nyxus_tpu import ImageQuality\n"
        "r = np.random.default_rng(21)\n"
        "img = r.integers(0, 4000, (96, 112)).astype(np.uint16)\n"
        "lab = np.zeros(img.shape, np.int32)\n"
        "lab[4:44, 6:60] = 1\n"
        "lab[50:90, 20:100] = 2\n"
        "ImageQuality(precision='f64').featurize(img, lab).to_csv(%r, "
        "index=False)\n"
    ) % (ROOT, HERE, out_csv)
    ref = _expected_cpu(script, out_csv)

    assert list(ref.ROI_label) == list(dev.ROI_label)
    for c in ("FOCUS_SCORE", "LOCAL_FOCUS_SCORE", "POWER_SPECTRUM_SLOPE",
              "MIN_SATURATION", "MAX_SATURATION", "SHARPNESS"):
        np.testing.assert_allclose(dev[c].to_numpy(float),
                                   ref[c].to_numpy(float),
                                   rtol=parity.F32_TOL, atol=1e-6, err_msg=c)
