import numpy as np
import pytest

from pose_refine import mesh


def test_icosphere_geometry():
    m = mesh.make_icosphere(radius=50.0, subdivisions=2)
    assert m.n_tris == 320
    # all vertices on the sphere
    r = np.linalg.norm(m.vertices, axis=1)
    np.testing.assert_allclose(r, 50.0, atol=1e-3)
    np.testing.assert_allclose(m.bbox_max, [50, 50, 50], atol=0.5)


def test_ply_ascii_roundtrip(tmp_path):
    m = mesh.make_icosphere(radius=10.0, subdivisions=1)
    p = str(tmp_path / "ico.ply")
    mesh.save_ply_ascii(p, m.vertices, m.faces)
    m2 = mesh.Model.load(p, verbose=False)
    np.testing.assert_allclose(m2.vertices, m.vertices, atol=1e-4)
    np.testing.assert_array_equal(m2.faces, m.faces)
    np.testing.assert_allclose(m2.tris, m.tris, atol=1e-4)


def test_quad_fan_triangulation(tmp_path):
    p = str(tmp_path / "quad.ply")
    with open(p, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\nelement vertex 4\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
            "0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n"
        )
    m = mesh.Model.load(p, verbose=False)
    assert m.faces.shape == (2, 3)
    np.testing.assert_array_equal(m.faces, [[0, 1, 2], [0, 2, 3]])


def test_reference_asset_if_present():
    path = mesh.find_reference_ply()
    if path is None:
        pytest.skip("reference obj_06.ply not mounted")
    m = mesh.Model.load(path, verbose=False)
    # counts from the PLY header of LINEMOD obj_06 (SURVEY.md section 4)
    assert len(m.vertices) == 15736
    assert len(m.faces) == 31468
    assert m.tris.shape == (31468, 3, 3)
    # LINEMOD meshes are in mm; obj_06 is about 10 cm across
    extent = m.bbox_max - m.bbox_min
    assert 30 < extent.max() < 300


def test_simplify_vertex_clustering():
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)  # 5120 tris
    s = mesh.simplify_vertex_clustering(m, cell_size=6.0)
    assert 0 < s.n_tris < m.n_tris * 0.6
    # shape preserved: bbox within one cell
    np.testing.assert_allclose(s.bbox_min, m.bbox_min, atol=6.0)
    np.testing.assert_allclose(s.bbox_max, m.bbox_max, atol=6.0)
    # vertices still near the original surface (radius ~50 +- bumps +- cell)
    r = np.linalg.norm(s.vertices, axis=1)
    assert r.min() > 25 and r.max() < 75


def test_simplified_mesh_still_refines():
    """End-to-end: a 2mm-clustered mesh recovers the golden perturbation."""
    from tests.test_icp import reference_demo_poses
    import pose_refine as prt
    from pose_refine import geometry

    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    s = mesh.simplify_vertex_clustering(m, cell_size=2.0)
    assert s.n_tris < m.n_tris

    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.5
    pose1, pose2, ang = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=320, height=240, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    refiner = prt.PoseRefiner(s, K=K, width=320, height=240, max_points=8192, use_pallas=False)
    refiner.set_scene_depth(scene_depth)
    refined, res = refiner.refine(pose1)
    euler = np.asarray(
        geometry.rotation_to_euler(np.asarray(res.transformation)[:3, :3])
    )
    err = np.abs(euler - ang) / np.pi * 180.0
    assert (err < 2.0).all(), f"simplified-mesh refinement error {err} deg"


def test_benchmark_model_fallback(monkeypatch):
    # without the reference asset mounted, the benchmark falls back to a
    # procedural mesh of comparable triangle count (bench must still run)
    monkeypatch.setattr(mesh, "REFERENCE_ASSET_CANDIDATES", ("",))
    assert mesh.find_reference_ply() is None
    m = mesh.load_benchmark_model()
    assert m.n_tris > 10000


def test_ply_face_element_with_extra_list_property(tmp_path):
    """A face element carrying a second list (MeshLab wedge texcoords) must
    not have its texcoords misread as vertex indices (binary), and mixed
    scalar+list elements must keep the token stream aligned (ascii)."""
    import struct

    # --- binary: face = vertex_indices list + texcoord list ---
    p = tmp_path / "tex.ply"
    header = (
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 3\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"element face 1\n"
        b"property list uchar int vertex_indices\n"
        b"property list uchar float texcoord\n"
        b"end_header\n"
    )
    body = b"".join(struct.pack("<fff", *v) for v in
                    [(0, 0, 0), (1, 0, 0), (0, 1, 0)])
    body += struct.pack("<B3i", 3, 0, 1, 2)              # the real face
    body += struct.pack("<B6f", 6, *([0.25] * 6))        # wedge texcoords
    p.write_bytes(header + body)
    verts, faces = mesh.load_ply(str(p))
    assert verts.shape == (3, 3)
    np.testing.assert_array_equal(faces, [[0, 1, 2]])

    # --- ascii: an edge element mixing a scalar and a list before faces ---
    p2 = tmp_path / "mixed.ply"
    p2.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element edge 1\n"
        "property int flag\n"
        "property list uchar int verts\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0\n1 0 0\n0 1 0\n"
        "7 2 0 1\n"
        "3 0 1 2\n"
    )
    verts2, faces2 = mesh.load_ply(str(p2))
    assert verts2.shape == (3, 3)
    np.testing.assert_array_equal(faces2, [[0, 1, 2]])


def test_ply_vertex_element_with_list_property(tmp_path):
    """Vertex elements carrying a list property (e.g. per-vertex adjacency)
    must still yield x/y/z - the reference's Assimp loader handles arbitrary
    PLY layouts (renderer.cpp:11-150)."""
    import struct

    # --- ascii ---
    p = tmp_path / "vlist.ply"
    p.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property list uchar int adjacency\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 2 1 2\n"
        "1 0 0 1 0\n"
        "0 1 0 0\n"
        "3 0 1 2\n"
    )
    verts, faces = mesh.load_ply(str(p))
    np.testing.assert_allclose(verts, [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    np.testing.assert_array_equal(faces, [[0, 1, 2]])

    # --- binary: scalar intensity AFTER the list, exercising alignment ---
    p2 = tmp_path / "vlist_bin.ply"
    header = (
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 2\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"property list uchar int adjacency\n"
        b"property float intensity\n"
        b"element face 1\n"
        b"property list uchar int vertex_indices\n"
        b"end_header\n"
    )
    body = struct.pack("<fff", 1, 2, 3) + struct.pack("<B2i", 2, 0, 1) + struct.pack("<f", 0.5)
    body += struct.pack("<fff", 4, 5, 6) + struct.pack("<B", 0) + struct.pack("<f", 0.25)
    body += struct.pack("<B3i", 3, 0, 1, 0)
    p2.write_bytes(header + body)
    verts2, faces2 = mesh.load_ply(str(p2))
    np.testing.assert_allclose(verts2, [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(faces2, [[0, 1, 0]])


def test_ply_vertex_without_xyz_raises_specific_error(tmp_path):
    p = tmp_path / "noxyz.ply"
    p.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 1\n"
        "property float u\nproperty float v\n"
        "end_header\n"
        "0.5 0.5\n"
    )
    with pytest.raises(ValueError, match="no scalar x/y/z"):
        mesh.load_ply(str(p))


def test_simplify_rejects_absurd_cell_size():
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=2)
    with pytest.raises(ValueError, match="2\\^20"):
        mesh.simplify_vertex_clustering(m, cell_size=1e-6)
    with pytest.raises(ValueError, match="2\\^21"):
        mesh.simplify_vertex_clustering(m, cell_size=1e-6,
                                        split_normals=False)


def test_simplify_split_normals_key_cannot_overflow():
    """The 3-bit octant key costs each axis field one bit: a mesh spanning
    2^20 cells must RAISE under split_normals, not wrap the int64 key and
    silently merge vertices half the grid apart (the unit-mistake case the
    guard documents - e.g. a micron-unit mesh at a mm cell_size)."""
    span = float(1 << 20)  # cells at x=0 and x=2^20: old packing collided
    verts = np.array([
        [0, 0, 0], [1, 0, 0], [0, 1, 0],
        [span, 0, 0], [span + 1, 0, 0], [span, 1, 0],
    ], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    m = mesh.Model.from_vertices_faces(verts, faces)
    with pytest.raises(ValueError, match="2\\^20"):
        mesh.simplify_vertex_clustering(m, cell_size=1.0)
    # one bit narrower is legal and keeps the far clusters apart
    s = mesh.simplify_vertex_clustering(m, cell_size=2.0)
    assert len(s.vertices) >= 2
    assert np.ptp(s.vertices[:, 0]) > span / 2


# --- OBJ / STL loaders (Assimp-generality parity, renderer.cpp:11-150) ---


def test_obj_roundtrip_matches_ply(tmp_path):
    m = mesh.make_icosphere(radius=10.0, subdivisions=1)
    p = str(tmp_path / "ico.obj")
    with open(p, "w") as f:
        f.write("# comment\ng sphere\n")
        for v in m.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in m.faces + 1:  # OBJ is 1-based
            f.write(f"f {a} {b} {c}\n")
    m2 = mesh.Model.load(p, verbose=False)
    np.testing.assert_allclose(m2.vertices, m.vertices, atol=1e-4)
    np.testing.assert_array_equal(m2.faces, m.faces)


def test_obj_index_syntaxes_and_negative_indices(tmp_path):
    p = str(tmp_path / "quad.obj")
    with open(p, "w") as f:
        f.write(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
            "vt 0 0\nvn 0 0 1\n"
            "f 1/1 2/1/1 3//1 4\n"      # mixed i, i/t, i/t/n, i//n syntaxes
            "f -4 -3 -2\n"              # negative = relative to last vertex
        )
    m = mesh.Model.load(p, verbose=False)
    np.testing.assert_array_equal(
        m.faces, [[0, 1, 2], [0, 2, 3], [0, 1, 2]]
    )


def test_obj_skips_degenerate_and_rejects_bad_index(tmp_path):
    p = str(tmp_path / "deg.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2\nf 1 2 3\n")
    m = mesh.Model.load(p, verbose=False)  # 2-index face skipped (renderer.cpp:79)
    assert m.faces.shape == (1, 3)

    bad = str(tmp_path / "bad.obj")
    with open(bad, "w") as f:
        f.write("v 0 0 0\nf 1 2 3\n")
    with pytest.raises(ValueError, match="out of range"):
        mesh.load_obj(bad)


def test_stl_binary_and_ascii_roundtrip(tmp_path):
    import struct

    m = mesh.make_icosphere(radius=5.0, subdivisions=1)
    tris = m.tris  # (T, 3, 3)

    pb = str(tmp_path / "ico.stl")
    with open(pb, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 0))
            for v in t:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))
    mb = mesh.Model.load(pb, verbose=False)
    # welded mesh: same triangle soup (possibly renumbered), same vertex set
    assert mb.tris.shape == tris.shape
    def rowsort(a):
        return a[np.lexsort(a.T[::-1])]

    np.testing.assert_allclose(rowsort(mb.vertices), rowsort(m.vertices))
    np.testing.assert_allclose(np.sort(mb.tris.sum(axis=(1, 2))),
                               np.sort(tris.sum(axis=(1, 2))), rtol=1e-6)

    pa = str(tmp_path / "ico_ascii.stl")
    with open(pa, "w") as f:
        f.write("solid ico\n")
        for t in tris:
            f.write(" facet normal 0 0 0\n  outer loop\n")
            for v in t:
                f.write(f"   vertex {v[0]} {v[1]} {v[2]}\n")
            f.write("  endloop\n endfacet\n")
        f.write("endsolid ico\n")
    ma = mesh.Model.load(pa, verbose=False)
    np.testing.assert_array_equal(ma.vertices, mb.vertices)
    np.testing.assert_array_equal(ma.faces, mb.faces)


def test_unsupported_extension_raises(tmp_path):
    p = str(tmp_path / "mesh.fbx")
    open(p, "w").close()
    with pytest.raises(ValueError, match="unsupported mesh extension"):
        mesh.Model.load(p, verbose=False)


# ---------------------------------------------------------------------------
# glTF 2.0 / GLB scene-graph loader
# ---------------------------------------------------------------------------

def _make_glb(gltf_json: dict, bin_data: bytes) -> bytes:
    """Assemble a minimal GLB container (12-byte header + JSON + BIN chunks)."""
    import json
    import struct

    js = json.dumps(gltf_json).encode()
    js += b" " * (-len(js) % 4)
    bb = bin_data + b"\x00" * (-len(bin_data) % 4)
    body = (struct.pack("<I4s", len(js), b"JSON") + js
            + struct.pack("<I4s", len(bb), b"BIN\x00") + bb)
    return struct.pack("<4sII", b"glTF", 2, 12 + len(body)) + body


def _tri_glb_gltf(scale=None, rotation=None, translation=None, matrix=None,
                  instance_twice=False):
    """One right triangle (indexed u2) under an (optionally transformed)
    node; optionally a second untransformed instance of the same mesh."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    bin_data = pos.tobytes() + idx.tobytes()
    node = {"mesh": 0}
    for k, v in (("scale", scale), ("rotation", rotation),
                 ("translation", translation), ("matrix", matrix)):
        if v is not None:
            node[k] = v
    nodes = [node] + ([{"mesh": 0}] if instance_twice else [])
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{"byteLength": len(bin_data)}],
    }
    return gltf, bin_data


def test_glb_trs_node_transform(tmp_path):
    # scale 2, rotate 90 deg about +z (quaternion xyzw), translate (10, 0, 0):
    # glTF order is T @ R @ S, so (1,0,0) -> scaled (2,0,0) -> rotated
    # (0,2,0) -> translated (10,2,0)
    s = 2 ** -0.5
    gltf, bin_data = _tri_glb_gltf(scale=[2, 2, 2], rotation=[0, 0, s, s],
                                   translation=[10, 0, 0])
    p = str(tmp_path / "tri.glb")
    with open(p, "wb") as f:
        f.write(_make_glb(gltf, bin_data))
    m = mesh.Model.load(p, verbose=False)
    np.testing.assert_allclose(
        m.vertices, [[10, 0, 0], [10, 2, 0], [8, 0, 0]], atol=1e-5)
    np.testing.assert_array_equal(m.faces, [[0, 1, 2]])


def test_glb_column_major_matrix_and_instancing(tmp_path):
    # pure-translation matrix in glTF column-major order: translation lands
    # in elements 12..14; a second node instances the SAME mesh untransformed
    matrix = [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 5, 6, 7, 1]
    gltf, bin_data = _tri_glb_gltf(matrix=matrix, instance_twice=True)
    p = str(tmp_path / "two.glb")
    with open(p, "wb") as f:
        f.write(_make_glb(gltf, bin_data))
    m = mesh.Model.load(p, verbose=False)
    assert m.vertices.shape == (6, 3) and m.faces.shape == (2, 3)
    np.testing.assert_allclose(m.vertices[:3], np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]]) + [5, 6, 7], atol=1e-6)
    np.testing.assert_allclose(
        m.vertices[3:], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], atol=1e-6)
    np.testing.assert_array_equal(m.faces, [[0, 1, 2], [3, 4, 5]])


def test_glb_nested_hierarchy_composes_parent_then_child(tmp_path):
    # parent translates by (0, 0, 100); child rotates 90 deg about z THEN the
    # parent translation applies: (1,0,0) -> (0,1,0) -> (0,1,100)
    s = 2 ** -0.5
    gltf, bin_data = _tri_glb_gltf()
    gltf["nodes"] = [
        {"translation": [0, 0, 100], "children": [1]},
        {"mesh": 0, "rotation": [0, 0, s, s]},
    ]
    gltf["scenes"] = [{"nodes": [0]}]
    p = str(tmp_path / "nest.glb")
    with open(p, "wb") as f:
        f.write(_make_glb(gltf, bin_data))
    m = mesh.Model.load(p, verbose=False)
    np.testing.assert_allclose(
        m.vertices, [[0, 0, 100], [0, 1, 100], [-1, 0, 100]], atol=1e-5)


def test_gltf_json_embedded_base64_interleaved_nonindexed(tmp_path):
    # .gltf JSON file, data: URI buffer, POSITION interleaved with a dummy
    # normal (byteStride 24), non-indexed TRIANGLES primitive
    import base64
    import json

    inter = np.zeros((3, 6), np.float32)
    inter[:, :3] = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    bin_data = inter.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3,
                       "type": "VEC3"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(bin_data), "byteStride": 24}],
        "buffers": [{"byteLength": len(bin_data),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(bin_data).decode()}],
    }
    p = str(tmp_path / "tri.gltf")
    with open(p, "w") as f:
        json.dump(gltf, f)
    m = mesh.Model.load(p, verbose=False)
    np.testing.assert_allclose(
        m.vertices, [[0, 0, 0], [1, 0, 0], [0, 1, 0]], atol=1e-6)
    np.testing.assert_array_equal(m.faces, [[0, 1, 2]])


def test_gltf_external_bin_and_error_paths(tmp_path):
    import json

    gltf, bin_data = _tri_glb_gltf()
    gltf["buffers"] = [{"byteLength": len(bin_data), "uri": "tri.bin"}]
    with open(tmp_path / "tri.bin", "wb") as f:
        f.write(bin_data)
    p = str(tmp_path / "ext.gltf")
    with open(p, "w") as f:
        json.dump(gltf, f)
    m = mesh.Model.load(p, verbose=False)
    assert m.n_tris == 1

    # out-of-range index must raise, not wrap
    bad = json.loads(json.dumps(gltf))
    bad["accessors"][1]["count"] = 3
    badbin = bin_data[:36] + np.array([0, 1, 9], np.uint16).tobytes()
    with open(tmp_path / "tri.bin", "wb") as f:
        f.write(badbin)
    with open(p, "w") as f:
        json.dump(bad, f)
    with pytest.raises(ValueError, match="out of range"):
        mesh.Model.load(p, verbose=False)

    # a tightly-packed accessor whose count overruns its bufferView must
    # error, not silently read bytes from the NEXT bufferView
    with open(tmp_path / "tri.bin", "wb") as f:
        f.write(bin_data)
    overrun = json.loads(json.dumps(gltf))
    overrun["accessors"][0]["count"] = 4  # view holds 3 vec3 (36 bytes)
    with open(p, "w") as f:
        json.dump(overrun, f)
    with pytest.raises(ValueError, match="bufferView range"):
        mesh.Model.load(p, verbose=False)

    # lines-only scene (mode 1) has no triangles -> loud error
    with open(tmp_path / "tri.bin", "wb") as f:
        f.write(bin_data)
    lines = json.loads(json.dumps(gltf))
    lines["meshes"][0]["primitives"][0]["mode"] = 1
    with open(p, "w") as f:
        json.dump(lines, f)
    with pytest.raises(ValueError, match="no TRIANGLES"):
        mesh.Model.load(p, verbose=False)
