"""The port's tools against the JAX package's, on the CPU: the profiler,
``inference_time``, ``sustained_fps``, ``bench_matrix``, the visualization
modules, ``img2hdf5`` and the inference CLI's BEV snapshots.

- ``param_count`` against JAX's on the same carried weights (a narrowed
  ``stage1/m1_att`` model), the added modules' parameters of
  ``inference_time`` against the flax modules';
- ``flop_count`` against an analytic count of a tiny conv + matmul model
  (XLA's cost analysis of the flax twin is logged, not asserted: it counts
  by its own rules), the hand-written kernels by formula with
  their plain versions kept out of the library part, the peak table (an
  unknown card raises), ``mfu``;
- the profiler CLI, ``latency``, ``inference_time``, ``sustained_fps`` and
  ``bench_matrix`` on ``device="cpu"`` at tiny sizes, ``bench_matrix``'s
  config lists and its synthetic batch against the JAX tool's;
- ``simple_vis``, ``feature_analysis`` and ``paper_plots``: what they hand
  matplotlib (recorded from ``Axes``) against the JAX functions', the PNGs
  written; ``mmd_rbf`` and the t-SNE rows;
- ``img2hdf5`` on a fixture tree the test writes, against the JAX tool;
- ``inference --save_vis_interval`` writing its snapshots.

The card halves are ``cuda``-marked: the profiler on the card (FLOPs, MFU
in (0, 1]) skips here.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from gencomm_tpu_torch.config import yaml_utils
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.tools import bench_matrix, inference_time, profiler
from gencomm_tpu_torch.tools import sustained_fps
from gencomm_tpu_torch.visualization import (
    feature_analysis, paper_plots, simple_vis,
)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M1_ATT = "configs/opv2v/gencomm/stage1/m1_att.yaml"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tools' small models on one thread: the suite runs several
    workers on the machine's cores, where the many small operators (the
    NMS rounds, the profiler's hooks), each split over every core, wait on
    one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from gencomm_tpu.config import yaml_utils as jax_yaml
    from gencomm_tpu.models import create_model as jax_create_model
    from gencomm_tpu.tools import bench_matrix as jax_bench
    from gencomm_tpu.tools import profiler as jax_profiler

    from tests.test_torch_config import narrowed

    from types import SimpleNamespace

    return SimpleNamespace(**locals())


def _narrowed_yaml(tmp_path, **extra):
    from tests.test_torch_config import narrowed

    raw = narrowed(M1_ATT, **extra)
    y = tmp_path / "m1_att.yaml"
    y.write_text(yaml.safe_dump(raw))
    return str(y), raw


# ------------------------------------------------------------ profiler
def test_param_count_matches_jax(jx):
    """The narrowed m1_att model's parameters: the port's count against the
    JAX tool's ``param_count`` of the flax ``params`` tree."""
    from tests.test_torch_config import _shape_batch

    raw = jx.narrowed(M1_ATT)
    jh = jx.jax_yaml.update_yaml(copy.deepcopy(raw))
    jmodel = jx.jax_create_model(jh)
    shapes = jx.jax.eval_shape(lambda b: jmodel.init(
        {"params": jx.jax.random.PRNGKey(0),
         "diffusion": jx.jax.random.PRNGKey(1)}, b, train=False),
        _shape_batch(jh))
    with torch.device("meta"):
        model = create_model(yaml_utils.update_yaml(copy.deepcopy(raw)),
                             device="meta")
    assert profiler.param_count(model) == jx.jax_profiler.param_count(
        shapes["params"]) > 0


def test_flop_count_of_a_conv_and_a_matmul(jx, capsys):
    """A 3x3 conv (4 -> 8 channels, 16 x 16, SAME) and a dense layer (8 ->
    5 on 256 rows): 2 * 16 * 16 * 9 * 4 * 8 + 2 * 256 * 8 * 5 FLOPs, all
    in the library part; XLA's count of the flax twin is logged."""
    conv = torch.nn.Conv2d(4, 8, 3, padding=1, bias=False)
    lin = torch.nn.Linear(8, 5, bias=False)
    x = torch.randn(1, 4, 16, 16)

    def fn():
        y = conv(x).permute(0, 2, 3, 1).reshape(-1, 8)
        return lin(y)

    got = profiler.flop_count(fn)
    want = 2 * 16 * 16 * 9 * 4 * 8 + 2 * 256 * 8 * 5
    assert got["library"] == want and got["hand_kernels"] == 0
    assert got["total"] == want

    import flax.linen as nn

    class Twin(nn.Module):
        @nn.compact
        def __call__(self, v):
            v = nn.Conv(8, (3, 3), use_bias=False)(v)
            return nn.Dense(5, use_bias=False)(v.reshape(-1, 8))

    xj = jx.jnp.zeros((1, 16, 16, 4))
    twin = Twin()
    params = twin.init(jx.jax.random.PRNGKey(0), xj)
    xla = jx.jax_profiler.flops_estimate(lambda p, v: twin.apply(p, v),
                                         params, xj)
    with capsys.disabled():
        print(f"\nFLOPs: port {got['total']}, analytic {want}, XLA's cost "
              f"analysis {xla} (logged: XLA counts by its own rules)")


def test_hand_kernels_are_counted_by_formula():
    """K1 and K3 on CPU tensors: their plain versions run, but the counts
    are the kernels' formulas, none of it in the library part."""
    from gencomm_tpu_torch.ops import deform_conv, warp

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 8, 16, generator=gen)
    off = torch.randn(2, 6, 8, 18, generator=gen)
    w = torch.randn(3, 3, 16, 4, generator=gen)
    got = profiler.flop_count(lambda: deform_conv.deform_conv3x3(x, off, w))
    npix = 2 * 6 * 8
    assert got["library"] == 0
    assert got["by_kernel"] == {"deform_conv3x3": {
        "calls": 1, "flops": npix * (2 * 9 * 16 * 4 + 8 * 9 * 16)}}
    theta = torch.eye(2, 3)[None].repeat(2, 1, 1)
    got = profiler.flop_count(lambda: warp.warp_affine(x, theta))
    assert got["library"] == 0 and got["hand_kernels"] == 8 * x.numel()
    # the backward kernel is counted on the backward pass
    xr = x.clone().requires_grad_(True)
    got = profiler.flop_count(
        lambda: deform_conv.deform_conv3x3(xr, off, w).sum().backward())
    assert got["by_kernel"]["deform_conv3x3_bwd"]["flops"] == npix * (
        4 * 9 * 16 * 4 + 24 * 9 * 16)
    # outside the block the dispatch functions are the real ones again
    assert deform_conv.deform_conv3x3_fwd.__name__ == "deform_conv3x3_fwd"


def test_peak_table_mfu_and_an_unknown_card():
    assert profiler.peak_flops_per_s(
        "fp32", "NVIDIA H100 80GB HBM3") == 67e12
    assert profiler.peak_flops_per_s(
        "bf16", "NVIDIA H100 80GB HBM3") == 989e12
    assert profiler.peak_flops_per_s("fp32", "NVIDIA H100 PCIe") == 51e12
    with pytest.raises(ValueError, match="peak_tflops"):
        profiler.peak_flops_per_s("fp32", "NVIDIA A100-SXM4-80GB")
    assert profiler.peak_flops_per_s("fp32", "any card",
                                     peak_tflops=10.0) == 10e12
    assert profiler.mfu(67e9, 1e-2, 67e12) == pytest.approx(0.1)
    assert profiler.mfu(None, 1e-2, 67e12) is None


def test_latency_on_the_cpu_is_labelled_host_clock():
    res = profiler.latency(lambda: torch.randn(64, 64) @ torch.randn(64, 64),
                           iters=3, device="cpu")
    assert res["latency_ms"] > 0 and res["device"] == "cpu (host clock)"
    assert res["throughput_fps"] == pytest.approx(1e3 / res["latency_ms"])


@pytest.mark.parametrize("raw_points", [False, True])
def test_profiler_cli_on_the_cpu(tmp_path, capsys, raw_points):
    """The narrowed m1_att yaml through the CLI on the CPU: params, the
    frame's FLOPs (K1, K2 or the raw path, K3 and N1 by formula), both
    latencies and MFU against a given peak in (0, 1]; host-decorated with
    the op and module breakdowns, raw points (``--no_host_decorate``: no K2
    call) with the train step."""
    y, _ = _narrowed_yaml(tmp_path)
    argv = ["--hypes_yaml", y, "--device", "cpu", "--iters", "1",
            "--peak_tflops", "1"]
    argv += (["--no_host_decorate", "--train"] if raw_points
             else ["--trace", "--by_module"])
    res = profiler.main(argv)
    by_kernel = res["flops"]["by_kernel"]
    assert by_kernel["deform_conv3x3"]["calls"] == 1
    assert by_kernel["warp_affine"]["calls"] == 1
    assert by_kernel["nms_closure"]["calls"] == 1
    assert ("pillar_canvas" in by_kernel) is not raw_points
    assert res["flops"]["library"] > 0
    for key in ("looped", "streamed"):
        assert 0 < res[key]["mfu"] <= 1
    if raw_points:
        train = res["train"]
        assert "deform_conv3x3_bwd" in train["flops"]["by_kernel"]
        assert "pillar_canvas_bwd" not in train["flops"]["by_kernel"]
        assert 0 < train["mfu"] <= 1
    else:
        assert res["by_module"] and any("branch_m1" in r[2]
                                        for r in res["by_module"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"] == "cpu (host clock)" and last["params"] > 0


# ----------------------------------------------------- inference_time
def test_inference_time_on_the_cpu_and_its_params_match_jax(jx):
    """The added modules timed on the CPU at (2, 8, 16, 64); each module's
    parameters against the flax module's at the same width."""
    from gencomm_tpu.models.codebook import UMGMQuantizer as JQ
    from gencomm_tpu.models.gencomm.diffusion import GenCommDiffusion as JD
    from gencomm_tpu.models.gencomm.message_extractor import (
        MessageExtractor as JME,
    )

    res = inference_time.added_modules(8, 16, 64, iters=2, device="cpu")
    assert set(res) == {"gencomm_message_extractor", "gencomm_diffusion",
                        "mpda_resizer", "mpda_cdt", "codefilling_quantizer",
                        "stamp_adapter"}
    assert all(r["ms"] > 0 and r["device"] == "cpu (host clock)"
               for r in res.values())
    jnp, key = jx.jnp, jx.jax.random.PRNGKey(0)
    feat = jnp.zeros((2, 8, 16, 64))

    def count(module, *args):
        shapes = jx.jax.eval_shape(lambda: module.init(
            {"params": key, "diffusion": key}, *args))
        return jx.jax_profiler.param_count(shapes["params"]) / 1e6

    assert res["gencomm_message_extractor"]["params_M"] == pytest.approx(
        count(JME(in_ch=64, out_ch=2), feat))
    assert res["gencomm_diffusion"]["params_M"] == pytest.approx(count(
        JD(feat_ch=64, msg_ch=2, num_timesteps=3), feat,
        jnp.zeros((2, 8, 16, 2)), False))
    assert res["codefilling_quantizer"]["params_M"] == pytest.approx(count(
        JQ(channel=64, seg_num=2, dict_sizes=(64, 64, 64)),
        feat.reshape(-1, 64), False))


# ------------------------------------------------------ sustained_fps
def test_sustained_fps_on_the_cpu(tmp_path):
    y, _ = _narrowed_yaml(tmp_path)
    res = sustained_fps.main(["-y", y, "--frames", "2", "--device", "cpu"])
    for k in ("host_items_per_s", "device_fps", "sustained_fps"):
        assert res[k] > 0, k
    assert res["device"] == "cpu (host clock)"


# -------------------------------------------------------- bench_matrix
def test_bench_matrix_lists_match_the_jax_tool(jx):
    assert bench_matrix.DEFAULT_CONFIGS == jx.jax_bench.DEFAULT_CONFIGS
    assert bench_matrix.HETERO_BASE == jx.jax_bench.HETERO_BASE
    assert bench_matrix.HETERO_METHODS == jx.jax_bench.HETERO_METHODS
    for _, path, *_ in (bench_matrix.DEFAULT_CONFIGS
                        + [bench_matrix.HETERO_BASE]
                        + bench_matrix.HETERO_METHODS):
        assert os.path.exists(os.path.join(REPO, path)), path


@pytest.mark.parametrize("config", [
    "configs/opv2v/more_modality/2_modality_end2end/m1m2_att.yaml",
    "configs/opv2v/point_pillar_att.yaml"])
def test_bench_matrix_batch_matches_the_jax_tool(jx, config):
    """``synthetic_batch_for_hypes`` (undecorated, 4,000 points) gives the JAX
    tool's arrays: the sampler's points, the camera stacks, the trim."""
    path = os.path.join(REPO, config)
    _, want = jx.jax_bench.synthetic_batch_for_hypes(
        jx.jax_yaml.load_yaml(path), points_per_agent=4000,
        host_decorate=False)
    _, got = bench_matrix.synthetic_batch_for_hypes(
        yaml_utils.load_yaml(path), points_per_agent=4000,
        host_decorate=False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_bench_matrix_rows_on_the_cpu(tmp_path, capsys):
    """A row of the narrowed m1_att yaml (intermediate) and of its late
    mode on the CPU; a yaml the port cannot build prints its error row and
    the matrix goes on."""
    _, raw = _narrowed_yaml(tmp_path)
    for mode in ("intermediate", "late"):
        row = bench_matrix.bench_config(
            "m1_att_small", M1_ATT, mode, iters=1, device="cpu",
            hypes=yaml_utils.update_yaml(copy.deepcopy(raw)))
        assert row["ms_per_frame"] > 0 and row["streamed_ms_per_frame"] > 0
        assert row["params_M"] > 0 and row["device"] == "cpu (host clock)"
    missing = [("ciassd", "configs/opv2v/ciassd.yaml", "intermediate")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_matrix, "DEFAULT_CONFIGS", missing)
        rows = bench_matrix.main(["--iters", "1", "--device", "cpu"])
    assert len(rows) == 1 and "error" in rows[0]
    assert "ROADMAP item 19" in rows[0]["error"]
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["config"] == "ciassd"


# -------------------------------------------------------- visualization
class _Recorder:
    """What a plotting function hands matplotlib's Axes (plot, scatter,
    imshow: positional arrays and the keyword arguments), in call order."""

    def __init__(self, mp):
        import matplotlib.axes

        self.calls = []
        for name in ("plot", "scatter", "imshow"):
            real = getattr(matplotlib.axes.Axes, name)

            def rec(ax, *a, _real=real, _name=name, **k):
                self.calls.append((_name, [np.asarray(v, np.float64)
                                           if not isinstance(v, str) else v
                                           for v in a],
                                   {kk: vv for kk, vv in k.items()
                                    if isinstance(vv, (str, int, float))}))
                return _real(ax, *a, **k)

            mp.setattr(matplotlib.axes.Axes, name, rec)


def _same_calls(got, want):
    assert len(got) == len(want)
    for (gn, ga, gk), (wn, wa, wk) in zip(got, want):
        assert gn == wn and gk == wk
        assert len(ga) == len(wa)
        for g, w in zip(ga, wa):
            if isinstance(w, str):
                assert g == w
            else:
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


def _recorded(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        out = fn(*args, **kw)
    return rec.calls, out


def test_simple_vis_hands_matplotlib_what_jax_does(tmp_path):
    from gencomm_tpu.visualization import simple_vis as jvis

    rng = np.random.RandomState(0)
    pred = rng.uniform(-10, 10, (3, 8, 3))
    gt = rng.uniform(-10, 10, (2, 8, 3))
    pts = rng.uniform(-30, 30, (400, 4))
    lr = [-20.0, -10.0, -3.0, 20.0, 10.0, 1.0]
    want, _ = _recorded(jvis.visualize, pred, gt, pts, lr,
                        str(tmp_path / "jax.png"))
    got, path = _recorded(simple_vis.visualize, pred, gt, pts, lr,
                          str(tmp_path / "port.png"))
    _same_calls(got, want)
    assert os.path.getsize(path) > 0
    feat = rng.randn(8, 16, 4)
    for mode in ("mean", "max"):
        want, _ = _recorded(jvis.vis_bev_feature, feat,
                            str(tmp_path / "jf.png"), mode)
        got, path = _recorded(simple_vis.vis_bev_feature, feat,
                              str(tmp_path / "pf.png"), mode)
        _same_calls(got, want)
        assert os.path.getsize(path) > 0


def test_paper_plots_hand_matplotlib_what_jax_does(tmp_path):
    from gencomm_tpu.visualization import paper_plots as jpp

    res = {0.0: {"ap50": 0.8, "ap70": 0.6}, 0.4: {"ap50": 0.5},
           0.2: {"ap50": 0.7, "ap70": 0.4}}
    cases = [("plot_ap_curve", (res, "{}.png", "noise")),
             ("plot_scalability", ("{}.png",)),
             ("plot_scatter", ({"a": (1.0, 0.5), "b": (3.0, 0.7)}, "{}.png",
                               "fps"))]
    for name, args in cases:
        jargs = [str(tmp_path / a.format("j" + name)) if a == "{}.png" else a
                 for a in args]
        pargs = [str(tmp_path / a.format("p" + name)) if a == "{}.png" else a
                 for a in args]
        want, _ = _recorded(getattr(jpp, name), *jargs)
        got, path = _recorded(getattr(paper_plots, name), *pargs)
        _same_calls(got, want)
        assert os.path.getsize(path) > 0
    assert paper_plots.ADDED_PARAMS_M == jpp.ADDED_PARAMS_M
    # GenComm's added parameters counted on each package's own extractor
    assert paper_plots.measured_gencomm_added_params() == pytest.approx(
        jpp.measured_gencomm_added_params())
    for lv in (0.0, 0.2):
        (tmp_path / f"eval_noise_{lv}.yaml").write_text(
            yaml.safe_dump(res[lv]))
    assert paper_plots.collect_sweep(str(tmp_path), "noise") == \
        jpp.collect_sweep(str(tmp_path), "noise")
    wrote = paper_plots.main(["--model_dir", str(tmp_path), "--out",
                              str(tmp_path / "plots")])
    assert len(wrote) == 2 and all(os.path.getsize(p) > 0 for p in wrote)


def test_feature_analysis_matches_jax(tmp_path):
    from gencomm_tpu.visualization import feature_analysis as jfa

    rng = np.random.RandomState(1)
    a, b = rng.randn(40, 6), rng.randn(30, 6) + 0.5
    assert feature_analysis.mmd_rbf(a, b) == jfa.mmd_rbf(a, b)
    assert feature_analysis.mmd_rbf(a, b, gamma=0.3) == jfa.mmd_rbf(
        a, b, gamma=0.3)
    feats = {"m1": rng.randn(4, 5, 6), "m2": rng.randn(3, 7, 6) + 1.0}
    want = jfa.tsne_embed(feats, max_per_domain=12)
    got = feature_analysis.tsne_embed(feats, max_per_domain=12)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    want, _ = _recorded(jfa.plot_tsne, feats, str(tmp_path / "j" / "t.png"))
    got, path = _recorded(feature_analysis.plot_tsne, feats,
                          str(tmp_path / "p" / "t.png"))
    _same_calls(got, want)
    assert os.path.getsize(path) > 0
    fmap = rng.randn(1, 8, 16, 5)
    for kw in ({}, {"reduce": "max"}, {"channels": [0, 3]}):
        want, _ = _recorded(jfa.save_bev_feature, fmap,
                            str(tmp_path / "jb.png"), **kw)
        got, path = _recorded(feature_analysis.save_bev_feature, fmap,
                              str(tmp_path / "pb.png"), **kw)
        _same_calls(got, want)


# ----------------------------------------------------------- img2hdf5
def _fixture_tree(root, rng):
    from PIL import Image

    for scen, cav in (("s0", "641"), ("s0", "650"), ("s1", "7")):
        d = root / scen / cav
        d.mkdir(parents=True)
        for ts in ("000068", "000070"):
            for cam in range(4 if cav != "650" else 2):
                Image.fromarray(rng.randint(0, 255, (6, 9, 3), np.uint8)).save(
                    d / f"{ts}_camera{cam}.png")
    (root / "notes.txt").write_text("not a scenario")


def test_img2hdf5_packs_a_fixture_tree_as_the_jax_tool(tmp_path):
    import h5py

    from gencomm_tpu.tools import img2hdf5 as jimg
    from gencomm_tpu_torch.tools import img2hdf5

    for which in ("jax", "port"):
        _fixture_tree(tmp_path / which, np.random.RandomState(2))
    jimg.main(["--root", str(tmp_path / "jax")])
    assert img2hdf5.main(["--root", str(tmp_path / "port")]) == 6
    # an existing file is kept unless --overwrite
    assert img2hdf5.main(["--root", str(tmp_path / "port")]) == 0
    assert img2hdf5.main(["--root", str(tmp_path / "port"),
                          "--overwrite"]) == 6
    for scen, cav in (("s0", "641"), ("s0", "650"), ("s1", "7")):
        for ts in ("000068", "000070"):
            rel = os.path.join(scen, cav, f"{ts}_imgs.hdf5")
            with h5py.File(tmp_path / "jax" / rel) as fj, \
                    h5py.File(tmp_path / "port" / rel) as fp:
                assert sorted(fp) == sorted(fj)
                for k in fj:
                    np.testing.assert_array_equal(fp[k][()], fj[k][()])


# ---------------------------------------------- inference snapshots
def test_inference_cli_writes_bev_snapshots(tmp_path):
    """--save_vis_interval 2 over 3 frames: snapshots of frames 0 and 2."""
    from gencomm_tpu_torch.tools import inference, train as train_cli

    y, _ = _narrowed_yaml(tmp_path)
    run = str(tmp_path / "run")
    train_cli.main(["-y", y, "--model_dir", run, "--dataset", "synthetic",
                    "--device", "cpu", "--epochs", "1", "--steps_per_epoch",
                    "1", "--val_steps", "0"])
    inference.main(["--model_dir", run, "--dataset", "synthetic", "--frames",
                    "3", "--device", "cpu", "--save_vis_interval", "2"])
    vis = sorted(os.listdir(os.path.join(run, "vis")))
    assert vis == ["bev_00000.png", "bev_00002.png"]


# --------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_profiler_on_the_card(cuda, tmp_path):
    """The narrowed m1_att frame on the card: FLOPs in both parts, MFU
    against the named card's fp32 peak in (0, 1]."""
    from tests.test_torch_encoders import narrowed_legacy

    y = tmp_path / "m1_att.yaml"
    y.write_text(yaml.safe_dump(narrowed_legacy("m1_att_raw")))
    res = profiler.main(["--hypes_yaml", str(y), "--iters", "3"])
    assert res["flops"]["hand_kernels"] > 0 and res["flops"]["library"] > 0
    for key in ("looped", "streamed"):
        assert 0 < res[key]["mfu"] <= 1


def test_new_modules_import_without_jax_or_the_plotting_packages():
    """Every module of the tools and encoders imports with JAX blocked,
    and importing them loads neither matplotlib, scikit-learn, PIL nor
    h5py (the card machine has none of them)."""
    import subprocess
    import sys

    mods = ["ops.voxel", "models.encoders.voxelnet", "models.encoders.pixor",
            "models.ciassd", "tools.profiler", "tools.inference_time",
            "tools.sustained_fps", "tools.bench_matrix", "tools.img2hdf5",
            "tools.inference", "tools.train", "visualization.simple_vis",
            "visualization.feature_analysis", "visualization.paper_plots"]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            + "".join(f"importlib.import_module('gencomm_tpu_torch.{m}')\n"
                      for m in mods)
            + "print(sorted(m for m in ('matplotlib', 'sklearn', 'PIL', "
              "'h5py') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
