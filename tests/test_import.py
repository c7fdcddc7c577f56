"""mtsimport analog: COLLADA/OBJ → scene XML + .serialized round-trip
(ref: src/converter/collada.cpp, src/converter/converter.cpp)."""
import os
import textwrap

import numpy as np

from mitsuba_tpu import tools
from mitsuba_tpu.io.collada import load_collada

DAE = textwrap.dedent("""\
    <?xml version="1.0" encoding="utf-8"?>
    <COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema"
             version="1.4.1">
      <asset><up_axis>Z_UP</up_axis></asset>
      <library_cameras>
        <camera id="cam"><optics><technique_common>
          <perspective>
            <yfov>49.134</yfov><aspect_ratio>1.777</aspect_ratio>
            <znear>0.1</znear><zfar>100</zfar>
          </perspective>
        </technique_common></optics></camera>
      </library_cameras>
      <library_effects>
        <effect id="red-fx"><profile_COMMON><technique sid="common">
          <lambert><diffuse><color>0.8 0.1 0.1 1</color></diffuse>
          </lambert>
        </technique></profile_COMMON></effect>
        <effect id="shiny-fx"><profile_COMMON><technique sid="common">
          <phong>
            <diffuse><color>0.2 0.2 0.6 1</color></diffuse>
            <specular><color>0.9 0.9 0.9 1</color></specular>
            <shininess><float>64</float></shininess>
          </phong>
        </technique></profile_COMMON></effect>
      </library_effects>
      <library_materials>
        <material id="red"><instance_effect url="#red-fx"/></material>
        <material id="shiny"><instance_effect url="#shiny-fx"/></material>
      </library_materials>
      <library_geometries>
        <geometry id="quad"><mesh>
          <source id="quad-pos">
            <float_array id="quad-pos-arr" count="12">
              -1 -1 0  1 -1 0  1 1 0  -1 1 0</float_array>
            <technique_common>
              <accessor source="#quad-pos-arr" count="4" stride="3">
                <param name="X" type="float"/>
                <param name="Y" type="float"/>
                <param name="Z" type="float"/>
              </accessor>
            </technique_common>
          </source>
          <source id="quad-nrm">
            <float_array id="quad-nrm-arr" count="3">0 0 1</float_array>
            <technique_common>
              <accessor source="#quad-nrm-arr" count="1" stride="3"/>
            </technique_common>
          </source>
          <vertices id="quad-vtx">
            <input semantic="POSITION" source="#quad-pos"/>
          </vertices>
          <polylist material="MAT" count="1">
            <input semantic="VERTEX" source="#quad-vtx" offset="0"/>
            <input semantic="NORMAL" source="#quad-nrm" offset="1"/>
            <vcount>4</vcount>
            <p>0 0 1 0 2 0 3 0</p>
          </polylist>
        </mesh></geometry>
        <geometry id="tri"><mesh>
          <source id="tri-pos">
            <float_array id="tri-pos-arr" count="9">
              0 0 0  1 0 0  0 1 0</float_array>
            <technique_common>
              <accessor source="#tri-pos-arr" count="3" stride="3"/>
            </technique_common>
          </source>
          <vertices id="tri-vtx">
            <input semantic="POSITION" source="#tri-pos"/>
          </vertices>
          <triangles material="MAT2" count="1">
            <input semantic="VERTEX" source="#tri-vtx" offset="0"/>
            <p>0 1 2</p>
          </triangles>
        </mesh></geometry>
      </library_geometries>
      <library_visual_scenes>
        <visual_scene id="vs">
          <node name="quad-node">
            <translate>0 0 2</translate>
            <rotate>0 0 1 90</rotate>
            <scale>2 2 2</scale>
            <instance_geometry url="#quad">
              <bind_material><technique_common>
                <instance_material symbol="MAT" target="#red"/>
              </technique_common></bind_material>
            </instance_geometry>
          </node>
          <node name="tri-node">
            <matrix>1 0 0 5  0 1 0 0  0 0 1 0  0 0 0 1</matrix>
            <instance_geometry url="#tri">
              <bind_material><technique_common>
                <instance_material symbol="MAT2" target="#shiny"/>
              </technique_common></bind_material>
            </instance_geometry>
          </node>
          <node name="cam-node">
            <translate>0 -5 1</translate>
            <instance_camera url="#cam"/>
          </node>
        </visual_scene>
      </library_visual_scenes>
      <scene><instance_visual_scene url="#vs"/></scene>
    </COLLADA>
""")


def _write_dae(tmp_path):
    p = os.path.join(tmp_path, "scene.dae")
    with open(p, "w") as f:
        f.write(DAE)
    return p


def test_collada_parse(tmp_path):
    dae = load_collada(_write_dae(str(tmp_path)))
    assert dae.up_axis == "Z_UP"
    assert len(dae.instances) == 2
    quad = next(i for i in dae.instances if i.name == "quad-node")
    tri = next(i for i in dae.instances if i.name == "tri-node")
    # polylist quad fan-triangulated into 2 faces, de-indexed corners
    assert quad.mesh.faces.shape == (2, 3)
    assert quad.mesh.normals is not None
    assert np.allclose(quad.mesh.normals, [0, 0, 1])
    assert quad.material == "red"
    # node transform: translate·rotate(z,90°)·scale(2): +x → +y·2
    p = quad.to_world @ np.array([1.0, 0.0, 0.0, 1.0])
    assert np.allclose(p[:3], [0, 2, 2], atol=1e-6)
    # matrix element is row-major
    assert np.allclose(tri.to_world[:3, 3], [5, 0, 0])
    assert dae.materials["red"]["kd"] == (0.8, 0.1, 0.1)
    assert dae.materials["shiny"]["ns"] == 64.0
    # camera: yfov 49.134 @ aspect 1.777 → xfov ≈ 78.4°
    assert dae.camera is not None
    assert abs(dae.camera.xfov - 78.4) < 1.0
    assert np.allclose(dae.camera.to_world[:3, 3], [0, -5, 1])


def test_import_dae_renders(tmp_path):
    dae_path = _write_dae(str(tmp_path))
    out_xml = os.path.join(str(tmp_path), "out", "scene.xml")
    rc = tools.main(["import", dae_path, out_xml, "--res", "32x32",
                     "--spp", "4"])
    assert rc == 0
    assert os.path.exists(out_xml)
    from mitsuba_tpu.scene.xml import load_xml
    loaded = load_xml(out_xml)
    desc, camera = loaded.desc, loaded.camera
    assert len(desc.shapes) == 2
    assert camera.width == 32
    # Z_UP fix-up applied on top of the camera node: y_dae=-5 → z=-5... the
    # fix maps (x, y, z) → (x, z, -y), so position (0,-5,1) → (0, 1, 5)
    assert np.allclose(np.asarray(camera.to_world)[:3, 3], [0, 1, 5],
                       atol=1e-5)
    # orientation: our sensors look down local +Z (third rotation column);
    # the COLLADA camera looks down its node's -Z, so the exported view
    # direction must equal fix @ (0,0,-1) = (0,-1,0) for this Z_UP scene
    # (collada.cpp loadCamera bakes the same scale(1,1,-1) flip).
    view = np.asarray(camera.to_world)[:3, 2]
    assert np.allclose(view, [0, -1, 0], atol=1e-5)
    # end to end: compiles + renders finite pixels
    from mitsuba_tpu.film.film import Film
    from mitsuba_tpu.integrator.direct import DirectIntegrator
    from mitsuba_tpu.render import render
    from mitsuba_tpu.scene.builder import compile_scene
    scene = compile_scene(desc)
    img = np.asarray(render(scene, camera, Film(32, 32),
                            DirectIntegrator().specialized_for(scene),
                            spp=2, seed=0))
    assert np.isfinite(img).all()


def test_import_dae_x_up(tmp_path):
    """X_UP fix-up must map the old up axis (1,0,0) to (0,1,0) — the
    +90° rotation about Z, not its inverse (which flips scenes upside
    down)."""
    p = os.path.join(str(tmp_path), "xup.dae")
    with open(p, "w") as f:
        f.write(DAE.replace("Z_UP", "X_UP"))
    out_xml = os.path.join(str(tmp_path), "xup_out", "scene.xml")
    rc = tools.main(["import", p, out_xml, "--res", "16x16"])
    assert rc == 0
    from mitsuba_tpu.scene.xml import load_xml
    loaded = load_xml(out_xml)
    # tri node sits at (5,0,0) in the DAE — the old up axis direction —
    # so after the fix it must land at (0,5,0)
    tris = [s for s in loaded.desc.shapes
            if np.allclose(np.abs(np.asarray(s.to_world)[:3, 3]).max(), 5)]
    assert len(tris) == 1
    assert np.allclose(np.asarray(tris[0].to_world)[:3, 3], [0, 5, 0],
                       atol=1e-6)
    # camera node at (0,-5,1) → (5,0,1); view -Z stays -Z under this fix
    cam = np.asarray(loaded.camera.to_world)
    assert np.allclose(cam[:3, 3], [5, 0, 1], atol=1e-5)
    assert np.allclose(cam[:3, 2], [0, 0, -1], atol=1e-5)


def test_import_obj(tmp_path):
    obj = os.path.join(str(tmp_path), "m.obj")
    mtl = os.path.join(str(tmp_path), "m.mtl")
    with open(mtl, "w") as f:
        f.write("newmtl green\nKd 0.1 0.7 0.1\n")
    with open(obj, "w") as f:
        f.write("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                "usemtl green\nf 1 2 3\n")
    out_xml = os.path.join(str(tmp_path), "obj_out", "scene.xml")
    rc = tools.main(["import", obj, out_xml, "--res", "16x16"])
    assert rc == 0
    from mitsuba_tpu.scene.xml import load_xml
    loaded = load_xml(out_xml)
    assert len(loaded.desc.shapes) == 1
    mat = loaded.desc.materials[loaded.desc.shapes[0].material]
    assert np.allclose(mat.albedo, [0.1, 0.7, 0.1], atol=1e-6)


def test_joinrgb(tmp_path):
    from mitsuba_tpu.io.image import read_exr, write_image
    paths = []
    for i, name in enumerate(("r", "g", "b")):
        img = np.zeros((4, 4, 3), np.float32)
        img[..., 0] = (i + 1) * 0.25       # channel 0 carries the value
        p = os.path.join(str(tmp_path), f"{name}.exr")
        write_image(p, img)
        paths.append(p)
    out = os.path.join(str(tmp_path), "rgb.exr")
    rc = tools.main(["joinrgb", *paths, out])
    assert rc == 0
    img = read_exr(out)
    assert np.allclose(img[0, 0], [0.25, 0.5, 0.75], atol=1e-3)


def test_tracebench_runs(capsys):
    rc = tools.main(["tracebench", "scenes/cornell.xml",
                     "--rays", "4096"])
    assert rc == 0
    outp = capsys.readouterr().out
    assert "rays/s" in outp and "coherent" in outp
