"""Scene tables of the PyTorch port against the JAX package.

The port's uploader must give tables array-equal to hala_tpu's (same
cluster-slot order, padding, packing and dtypes), `from_numpy` must
carry a JAX DeviceScene across unchanged, and the stdlib PNG decoder
must match PIL byte for byte.
"""

import dataclasses
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

from hala_tpu.scene.cpu.scene import Scene as JScene
from hala_tpu.scene.loader.uploader import SceneUploader as JUploader
from hala_tpu.scene import procedural as jproc
from hala_tpu_torch.error import HalaRendererError
from hala_tpu_torch.scene.cpu.image_data import ImageData, decode_png
from hala_tpu_torch.scene.cpu.scene import Scene as TScene
from hala_tpu_torch.scene.gpu.scene import DeviceScene, from_numpy
from hala_tpu_torch.scene.loader.uploader import SceneUploader as TUploader
from hala_tpu_torch.scene import procedural as tproc


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    more threads per worker only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
TABLES = ("geometry", "materials", "lights", "cameras", "textures")


def _jax_and_torch(name):
    if name == "cornell":
        return jproc.cornell_box(), tproc.cornell_box()
    if name == "sponza_like":
        kw = dict(rooms=(7, 7), columns_per_room=4, boxes_per_room=3)
        return jproc.sponza_like(**kw), tproc.sponza_like(**kw)
    path = os.path.join(ASSETS, "atrium.glb")
    return JScene.load(path), TScene.load(path)


@pytest.fixture(scope="module", params=["cornell", "sponza_like", "atrium"])
def uploaded(request):
    js, ts = _jax_and_torch(request.param)
    jdev = JUploader.upload(js, use_ray_tracing=False)
    tdev = TUploader.upload(ts, device="cpu")
    return request.param, jdev, tdev


def _assert_table_equal(name, jt, tt):
    assert (jt is None) == (tt is None), name
    if tt is None:
        return
    for f in dataclasses.fields(tt):
        tv = getattr(tt, f.name)
        jv = getattr(jt, f.name)
        if isinstance(tv, torch.Tensor):
            ja = np.asarray(jv)
            assert tv.device.type == "cpu"
            assert str(tv.dtype).split(".")[-1] == str(ja.dtype), (name, f.name)
            np.testing.assert_array_equal(tv.numpy(), ja, err_msg=f"{name}.{f.name}")
        else:
            assert tv == jv, (name, f.name, tv, jv)


def test_tables_equal(uploaded):
    scene_name, jdev, tdev = uploaded
    for table in TABLES:
        _assert_table_equal(
            f"{scene_name}.{table}", getattr(jdev, table), getattr(tdev, table)
        )
    assert tdev.prim_node == jdev.prim_node


def test_slot_layout_and_masking(uploaded):
    """Real triangles are exactly the tri_mat >= 0 slots; the prefix
    layout holds below 4096 triangles only; padding slots are inert."""
    scene_name, _, tdev = uploaded
    g = tdev.geometry
    real = (g.tri_mat >= 0).numpy()
    assert real.sum() == g.num_triangles
    assert g.tri_v0.shape[0] % 128 == 0
    assert g.prefix_layout == (g.num_triangles <= 4096)
    if g.prefix_layout:
        assert real[: g.num_triangles].all()
    else:
        assert not real[: g.num_triangles].all()  # interior padding
    assert (g.tri_e1.numpy()[~real] == 0).all()
    assert (g.tri_e2.numpy()[~real] == 0).all()
    # the packed cluster blocks hold the same slots as the flat columns
    rows = g.tri_packed[:, 0:9, :].permute(0, 2, 1).reshape(-1, 9)
    np.testing.assert_array_equal(rows[:, 0:3].numpy(), g.tri_v0.numpy())
    np.testing.assert_array_equal(rows[:, 6:9].numpy(), g.tri_e2.numpy())
    # shade rows carry the same material as tri_mat
    np.testing.assert_array_equal(
        g.shade_table[:, 18].numpy()[real], g.tri_mat.numpy()[real]
    )


def test_from_numpy_round_trip(uploaded):
    scene_name, jdev, tdev = uploaded
    carried = from_numpy(jdev, "cpu")
    assert isinstance(carried, DeviceScene)
    for table in TABLES:
        _assert_table_equal(
            f"{scene_name}.{table}", getattr(jdev, table), getattr(carried, table)
        )
    again = from_numpy(carried, "cpu")
    for table in TABLES:
        _assert_table_equal(table, getattr(carried, table), getattr(again, table))
    moved = tdev.to("cpu")
    assert moved.device.type == "cpu"
    assert moved.geometry.num_triangles == tdev.geometry.num_triangles


def test_device_rule():
    """device="cuda" on a host without CUDA raises instead of silently
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(HalaRendererError, match="cuda"):
        TUploader.upload(tproc.cornell_box())
    with pytest.raises(HalaRendererError, match="cuda"):
        TUploader.upload(tproc.cornell_box(), device="cpu").to("cuda")


def test_procedural_spheres_raise():
    """Procedural spheres raised while unported; now the uploader's
    sphere table equals the JAX package's, and `from_numpy` carries the
    JAX table over."""
    from hala_tpu.scene.cpu.prims import ProceduralSphere as JSphere
    from hala_tpu_torch.scene.cpu.prims import ProceduralSphere

    spheres = [((0.0, 0.0, 0.0), 0.5, 0), ((0.25, -0.5, 0.1), 0.2, 3)]
    scene = tproc.cornell_box()
    scene.procedurals = [ProceduralSphere(*s) for s in spheres]
    jscene = jproc.cornell_box()
    jscene.procedurals = [JSphere(*s) for s in spheres]
    got = TUploader.upload(scene, device="cpu").procedural
    ref = JUploader.upload(jscene, use_ray_tracing=False).procedural
    carried = from_numpy(JUploader.upload(jscene, use_ray_tracing=False), "cpu").procedural
    assert got.num_prims == ref.num_prims == carried.num_prims == 2
    for name in ("center", "radius", "mat", "packed"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
        assert torch.equal(getattr(got, name), getattr(carried, name))


def test_no_camera_raises():
    scene = tproc.cornell_box()
    for node in scene.nodes:
        node.camera_index = None
    with pytest.raises(HalaRendererError, match="Scene has no camera"):
        TUploader.upload(scene, device="cpu")


def test_unsupported_format():
    with pytest.raises(HalaRendererError, match="Unsupported scene file"):
        TScene.load("x.obj")


# --- PNG decoding without PIL ------------------------------------------------


def _glb_pngs(path):
    with open(path, "rb") as f:
        data = f.read()
    off = 12
    chunks = []
    while off < len(data):
        length, _ = struct.unpack("<II", data[off:off + 8])
        chunks.append(data[off + 8:off + 8 + length])
        off += 8 + length
    doc, binary = json.loads(chunks[0]), chunks[1]
    out = []
    for im in doc["images"]:
        view = doc["bufferViews"][im["bufferView"]]
        start = view.get("byteOffset", 0)
        out.append(binary[start:start + view["byteLength"]])
    return out


def _pil_rgba(data):
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode not in ("RGB", "RGBA"):
        img = img.convert("RGBA")
    return np.asarray(img)


def test_png_decoder_matches_pil_on_atrium_textures():
    pngs = _glb_pngs(os.path.join(ASSETS, "atrium.glb"))
    assert len(pngs) == 2
    for data in pngs:
        ours = decode_png(data)
        ref = _pil_rgba(data)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_decoder_matches_pil_per_color_type(mode):
    """Every 8-bit color type, through PIL's own (adaptive) filters."""
    from PIL import Image

    rs = np.random.RandomState(5)
    base = rs.randint(0, 256, (23, 37, 4)).astype(np.uint8)
    base[:, :, :3] = np.cumsum(base[:, :, :3] // 16, axis=1).astype(np.uint8)
    img = Image.fromarray(base, "RGBA").convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG", optimize=True)
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_png(data), _pil_rgba(data))


def test_png_decoder_used_without_pil(monkeypatch):
    import builtins

    data = _glb_pngs(os.path.join(ASSETS, "atrium.glb"))[0]
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    img = ImageData.load(data)
    monkeypatch.undo()
    np.testing.assert_array_equal(img.pixels, ImageData.from_array(_pil_rgba(data)).pixels)
    with pytest.raises(HalaRendererError):
        decode_png(b"\x89PNG\r\n\x1a\n" + struct.pack(">I4s", 13, b"IHDR")
                   + struct.pack(">IIBBBBB", 1, 1, 16, 2, 0, 0, 0) + b"\0" * 4)


def test_native_and_numpy_sah_slot_maps_agree(monkeypatch):
    """The port's native loader and the numpy builder give one slot map."""
    from hala_tpu_torch import native
    from hala_tpu_torch.ops import sahbuild

    if native.get_lib() is None:
        pytest.skip("no C++ toolchain: only the numpy builder exists here")
    rs = np.random.RandomState(13)
    c = rs.uniform(-10, 10, (6000, 3)).astype(np.float32)
    e = rs.uniform(0.01, 0.5, (6000, 3)).astype(np.float32)
    with_native = sahbuild.sah_slot_map(c - e, c + e, 128)
    monkeypatch.setattr(native, "sah_leaves_native", lambda *a, **k: None)
    numpy_only = sahbuild.sah_slot_map(c - e, c + e, 128)
    np.testing.assert_array_equal(with_native, numpy_only)
