"""The port's artifact renderer (its own PNG writer, no matplotlib).

The colour tables are held against matplotlib's (within 1/255; matplotlib
is used here only), the imshow arrays against the JAX package's ``_imshow``
(captured at its ``plt.imshow`` call, exactly equal), and every written
PNG is decoded with Pillow and read back pixel for pixel where a node, an
edge, an imshow cell or a series point lies (exact colours).
"""

import os

import matplotlib
import numpy as np
import pytest
from PIL import Image

from flipcomplexityempirical_tpu_torch import graphs
from flipcomplexityempirical_tpu_torch.experiments import (
    ARTIFACT_KINDS, ExperimentConfig, is_done)
from flipcomplexityempirical_tpu_torch.experiments import artifacts as art
from flipcomplexityempirical_tpu_torch.experiments import png

GRAPHS = {"sec11": graphs.grid_sec11, "frank": graphs.frankengraph}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def family_graph(request):
    return request.param, GRAPHS[request.param]()


def decode(path) -> np.ndarray:
    with Image.open(path) as im:
        assert im.mode == "RGB"
        return np.asarray(im)


@pytest.mark.parametrize("name", ["jet", "tab20"])
def test_colour_tables_match_matplotlib(name):
    x = np.concatenate([np.linspace(0.0, 1.0, 20001),
                        np.arange(257) / 256.0, np.arange(21) / 20.0])
    want = matplotlib.colormaps[name](x)[:, :3]
    assert np.abs(png.cmap_float(name, x) - want).max() <= 1 / 255


def test_normalize_is_min_max():
    np.testing.assert_allclose(png.normalize([2.0, 4.0, 3.0]),
                               [0.0, 1.0, 0.5])
    np.testing.assert_array_equal(png.normalize([5, 5]), [0.0, 0.0])


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)
    png.write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(decode(tmp_path / "x.png"), img)
    assert not os.path.exists(tmp_path / "x.png.tmp")


def test_imshow_grid_matches_jax_layout(family_graph, monkeypatch):
    from flipcomplexityempirical_tpu.experiments import artifacts as jart
    family, g = family_graph
    values = np.random.default_rng(1).normal(size=g.n_nodes)
    seen = []
    monkeypatch.setattr(jart.plt, "imshow",
                        lambda a2, **kw: seen.append(np.array(a2)))
    monkeypatch.setattr(jart.plt, "colorbar", lambda *a, **kw: None)
    monkeypatch.setattr(jart.plt, "savefig", lambda *a, **kw: None)
    jart._imshow(g, family, values, "unused.png")
    got = art.imshow_grid(g, family, values)
    assert got.shape == {"sec11": (40, 40), "frank": (20, 40)}[family]
    np.testing.assert_array_equal(got, seen[0])


def _run_like_data(g, rng, t_len=5000):
    n, e = g.n_nodes, g.n_edges
    slopes = rng.normal(size=t_len).astype(np.float32)
    slopes[::97] = np.nan
    slopes[5::211] = np.inf
    return dict(
        end_signed=np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32),
        cut_times=rng.integers(0, 1000, e).astype(np.int32),
        part_sum=rng.integers(-t_len, t_len, n).astype(np.int32),
        num_flips=rng.integers(0, 300, n).astype(np.int32),
        slopes=slopes,
        angles=rng.uniform(0.5, 3.0, t_len).astype(np.float32),
        waits_sum=12345.5)


def test_artifacts_show_their_values(family_graph, tmp_path):
    family, g = family_graph
    rng = np.random.default_rng(2)
    cfg = ExperimentConfig(family=family, alignment=1, base=0.3,
                           pop_tol=0.5)
    plan = (graphs.sec11_plan(g, 1) if family == "sec11"
            else graphs.frank_plan(g, 1))
    start = graphs.PARITY_LABELS[plan]
    data = _run_like_data(g, rng)
    out = str(tmp_path)
    art.render_start(g, out, cfg.tag, start)
    assert not is_done(cfg, out)
    art.render_all(g, family, out, cfg.tag, **data)
    assert sorted(os.listdir(out)) == sorted(cfg.tag + k
                                             for k in ARTIFACT_KINDS)
    assert is_done(cfg, out)
    assert (tmp_path / (cfg.tag + "wait.txt")).read_text() == "12346"

    rows, cols, _ = art.node_pixels(g)
    lognum = np.log(data["num_flips"] + 1.0)
    for kind, values, cmap in (("start", start, "tab20"),
                               ("end", data["end_signed"], "tab20"),
                               ("wca", data["part_sum"], "jet"),
                               ("flip", data["num_flips"], "jet"),
                               ("logflip", lognum, "jet")):
        img = decode(tmp_path / f"{cfg.tag}{kind}.png")
        np.testing.assert_array_equal(img[rows, cols],
                                      png.colorize(values, cmap),
                                      err_msg=kind)
    # the two district colours of tab20 after min-max normalisation
    assert {tuple(c) for c in png.colorize([-1, 1], "tab20")} == {
        (0x1F, 0x77, 0xB4), (0x9E, 0xDA, 0xE5)}

    for kind, values in (("end2", data["end_signed"]),
                         ("wca2", data["part_sum"]),
                         ("flip2", data["num_flips"]),
                         ("logflip2", lognum)):
        a2 = art.imshow_grid(g, family, values)
        img = decode(tmp_path / f"{cfg.tag}{kind}.png")
        ii, jj = np.indices(a2.shape)
        r, c = art.cell_pixel(ii, jj)
        np.testing.assert_array_equal(img[r, c], png.colorize(a2, "jet"),
                                      err_msg=kind)

    img = decode(tmp_path / f"{cfg.tag}edges.png")
    lab = np.asarray(g.labels)
    u, v = g.edges[:, 0], g.edges[:, 1]
    rook = np.abs(lab[u] - lab[v]).sum(axis=1) == 1
    mid_r = (rows[u] + rows[v])[rook] // 2
    mid_c = (cols[u] + cols[v])[rook] // 2
    np.testing.assert_array_equal(
        img[mid_r, mid_c], png.colorize(data["cut_times"], "jet")[rook])
    np.testing.assert_array_equal(img[rows, cols],
                                  np.broadcast_to([0, 0, 128],
                                                  (g.n_nodes, 3)))

    for kind, series, ylim in (("slope", data["slopes"], None),
                               ("angle", data["angles"], art.ANGLE_YLIM)):
        img = decode(tmp_path / f"{cfg.tag}{kind}.png")
        assert img.shape == art.LINE_SIZE + (3,)
        top, left, bottom, right = art.LINE_BOX
        assert (img[top, left:right + 1] == 0).all()
        assert (img[top:bottom + 1, right] == 0).all()
        px, py = art.series_pixels(series, ylim)
        ok = np.isfinite(py)
        assert ok.sum() > 0.9 * series.size
        np.testing.assert_array_equal(
            img[np.rint(py[ok]).astype(int), np.rint(px[ok]).astype(int)],
            np.broadcast_to(png.LINE_BLUE, (int(ok.sum()), 3)), err_msg=kind)
    _, py = art.series_pixels(data["angles"], art.ANGLE_YLIM)
    np.testing.assert_allclose(
        py, art.LINE_BOX[2] - data["angles"] / 6.3
        * (art.LINE_BOX[2] - art.LINE_BOX[0]), rtol=1e-6)


def test_series_without_finite_values_draws_the_box():
    img = art.line_image(np.full(10, np.nan))
    top, left, bottom, right = art.LINE_BOX
    inside = img[top + 1:bottom, left + 1:right]
    assert (inside == 255).all()
    assert (img[bottom, left:right + 1] == 0).all()
