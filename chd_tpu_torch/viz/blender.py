"""Blender rendering of physics-mocap results (runs under ``blender -b -P``;
port of chd_tpu/viz/blender.py, on the port's ``physics.towr_io`` and
``characters``).

Capability-equivalent of src/viz/viz_blender.py:33-880, written for the
Blender 2.8+ python API (the reference targets 2.79b). Not importable
outside Blender — everything is gated on ``bpy``.

Pipeline (reference anchors):
- pick the best converged result from success_log.txt — durations preferred
  over dynamics (viz_blender.py:570-595);
- build the floor plane from floor_out.txt (:164-236);
- import the character FBX, strip its rest armature, import the result BVH
  and parent the mesh with automatic weights (:681-738, :390-421);
- camera + sun lighting framing the motion bounds (:238-349);
- optional COM sphere and per-foot force arrows keyframed from the loaded
  solution (:423-540);
- render N views to frame PNGs, then assemble mp4s (:372-381).

Usage:
  blender -b -P chd_tpu_torch/viz/blender.py -- \
      --video-dir <dir> --character ybot --fbx <char.fbx> \
      [--views 2] [--out render_out]
(the script bootstraps its package imports when executed as a file)
"""
from __future__ import annotations

import argparse
import math
import os
import sys

if __package__ in (None, ""):  # executed as a file under `blender -P`
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    __package__ = "chd_tpu_torch.viz"

try:
    import bpy  # type: ignore
    from mathutils import Vector  # type: ignore

    HAVE_BPY = True
except ImportError:  # not running inside Blender
    HAVE_BPY = False

# Mixamo character name → store ID and per-character FBX normalization
# scale — constant data that must match the reference tables for asset
# compatibility (viz_blender.py:33-48, :50-65).
CHARACTER_NAME_TO_ID = {
    "liam": "44939_Liam",
    "remy": "44942_Remy",
    "malcolm": "44940_Malcolm",
    "stefani": "44944_Stefani",
    "douglas": "45049_Douglas",
    "regina": "44941_Regina",
    "shae": "44943_Shae",
    "swat": "254_Swat",
    "lola": "893_Lola_B_Styperek",
    "derrick": "363_Derrick",
    "pearl": "45051_Pearl",
    "jasper": "45050_Jasper",
    "exored": "132_Exo_Red",
    "ybot": "45276_Y_Bot",
    "ty": "910_Ty",
    "skeletonzombie": "968_Skeletonzombie_T_Avelange",
}
_ID_SCALE = {
    "44939_Liam": 0.005, "44942_Remy": 0.005, "44940_Malcolm": 0.005,
    "44944_Stefani": 0.005, "45049_Douglas": 0.01, "44941_Regina": 0.005,
    "44943_Shae": 0.005, "254_Swat": 0.01, "893_Lola_B_Styperek": 0.01,
    "363_Derrick": 0.01, "45051_Pearl": 0.01, "45050_Jasper": 0.01,
    "132_Exo_Red": 0.01, "45276_Y_Bot": 0.01, "910_Ty": 0.01,
    "968_Skeletonzombie_T_Avelange": 0.01,
}
# name → FBX import scale (relative to the 0.01 BVH/world normalization)
CHARACTER_SCALE = {
    name: _ID_SCALE[cid] / 0.01 for name, cid in CHARACTER_NAME_TO_ID.items()
}


def estimate_kinematic_forces(com_traj, floor_normal, mass, fps: float = 30.0):
    """Estimated ground-reaction force for a KINEMATIC-ONLY result:
    F = m·(a − g) from central-difference COM acceleration, gravity along
    −floor_normal (viz_blender.py:637-659 — the paper's side-by-side showing
    how noisy un-physics'd forces are). Pure numpy, anim coords (meters).

    com_traj: (F, 3), an array or a tensor on any device; returns (F, 1, 3)
    single net force applied at the COM.
    """
    import numpy as np

    from chd_tpu_torch.viz.video import to_host

    com_traj, floor_normal, mass = to_host((com_traj, floor_normal, mass))
    com = np.asarray(com_traj, float)
    n = np.asarray(floor_normal, float)
    n = n / max(np.linalg.norm(n), 1e-12)
    h = 1.0 / fps
    if com.shape[0] < 3:
        accel = np.zeros_like(com)
    else:
        interior = (com[2:] - 2 * com[1:-1] + com[:-2]) / (h * h)
        accel = np.concatenate([interior[:1], interior, interior[-1:]], axis=0)
    g = -n[None, :] * 9.81
    force = mass * (accel - g)
    return force.reshape((com.shape[0], 1, 3))


def pick_result(phys_out_dir: str):
    """Choose durations > dynamics result by success_log (ref :570-595)."""
    from chd_tpu_torch.physics.towr_io import load_success_log

    log_path = os.path.join(phys_out_dir, "success_log.txt")
    log = load_success_log(log_path) if os.path.exists(log_path) else {}
    if log.get("durations"):
        return "durations"
    if log.get("dynamics"):
        return "dynamics"
    return "no_dynamics"


if HAVE_BPY:

    def clear_scene():
        bpy.ops.object.select_all(action="SELECT")
        bpy.ops.object.delete(use_global=False)

    def setup_floor(floor_file: str, size: float = 10.0):
        with open(floor_file) as f:
            normal = [float(x) for x in f.readline().split()]
            point = [float(x) for x in f.readline().split()]
        # animation coords (cm, y-down) → blender (m, z-up)
        n = Vector((-normal[0], -normal[2], -normal[1])).normalized()
        p = Vector((-point[0], -point[2], -point[1])) * 0.01
        bpy.ops.mesh.primitive_plane_add(size=size, location=p)
        plane = bpy.context.active_object
        plane.rotation_mode = "QUATERNION"
        plane.rotation_quaternion = Vector((0, 0, 1)).rotation_difference(n)
        mat = bpy.data.materials.new("floor")
        mat.diffuse_color = (0.8, 0.8, 0.8, 1.0)
        plane.data.materials.append(mat)
        return plane, n, p

    def import_character(fbx_path: str, bvh_path: str, scale: float = 1.0):
        """FBX mesh + result BVH armature, mesh parented with auto weights
        (ref parent_to_armature:390-421)."""
        before = set(bpy.data.objects)
        bpy.ops.import_scene.fbx(filepath=fbx_path, global_scale=scale)
        fbx_objs = [o for o in set(bpy.data.objects) - before]
        meshes = [o for o in fbx_objs if o.type == "MESH"]
        for o in fbx_objs:  # strip the FBX rest armature (ref :712-732)
            if o.type == "ARMATURE":
                bpy.data.objects.remove(o, do_unlink=True)

        before = set(bpy.data.objects)
        bpy.ops.import_anim.bvh(
            filepath=bvh_path, global_scale=0.01, axis_forward="-Z", axis_up="Y"
        )
        armature = [o for o in set(bpy.data.objects) - before][0]

        for mesh in meshes:
            mesh.select_set(True)
        armature.select_set(True)
        bpy.context.view_layer.objects.active = armature
        bpy.ops.object.parent_set(type="ARMATURE_AUTO")
        return armature, meshes

    def setup_camera_and_light(center, radius, view_idx: int = 0, num_views: int = 2):
        # remove any previous view's rig so lights don't accumulate across views
        for obj in list(bpy.data.objects):
            if obj.type in ("CAMERA", "LIGHT"):
                bpy.data.objects.remove(obj, do_unlink=True)
        angle = 2 * math.pi * view_idx / max(num_views, 1) - math.pi / 2
        cam_loc = center + Vector(
            (radius * 2.5 * math.cos(angle), radius * 2.5 * math.sin(angle), radius)
        )
        bpy.ops.object.camera_add(location=cam_loc)
        cam = bpy.context.active_object
        direction = center - cam_loc
        cam.rotation_euler = direction.to_track_quat("-Z", "Y").to_euler()
        bpy.context.scene.camera = cam

        bpy.ops.object.light_add(type="SUN", location=center + Vector((0, 0, 5)))
        return cam

    def draw_com_and_forces(results, frame_start: int = 1, force_scale: float = 1e-3,
                            feet_pos=None, feet_force=None):
        """COM sphere + per-foot force arrows keyframed per frame (ref :423-540).

        feet_pos/feet_force override the solution's own feet arrays — used by
        the kinematic-only pass, which applies one estimated F=m(a−g) force
        at the COM itself (viz_blender.py:637-659)."""
        import numpy as np

        bpy.ops.mesh.primitive_uv_sphere_add(radius=0.05)
        com = bpy.context.active_object
        com.name = "COM"
        F = results.base_pos.shape[0]
        for f in range(F):
            p = results.base_pos[f]
            com.location = (-p[0], -p[2], -p[1])
            com.keyframe_insert(data_path="location", frame=frame_start + f)

        if feet_pos is None:
            feet_pos = results.feet_pos
        if feet_force is None:
            feet_force = results.feet_force
        feet_pos = np.asarray(feet_pos)
        feet_force = np.asarray(feet_force)

        arrows = []
        E = feet_pos.shape[1]
        for e in range(E):
            bpy.ops.mesh.primitive_cylinder_add(radius=0.01, depth=1.0)
            arrow = bpy.context.active_object
            arrow.name = f"force{e}"
            arrows.append(arrow)
            for f in range(F):
                foot = feet_pos[f, e]
                force = feet_force[f, e] * force_scale
                base = Vector((-foot[0], -foot[2], -foot[1]))
                vec = Vector((-force[0], -force[2], -force[1]))
                length = max(vec.length, 1e-6)
                arrow.location = base + vec * 0.5
                arrow.rotation_mode = "QUATERNION"
                arrow.rotation_quaternion = Vector((0, 0, 1)).rotation_difference(
                    vec.normalized() if vec.length > 1e-9 else Vector((0, 0, 1))
                )
                arrow.scale = (1.0, 1.0, length)
                arrow.keyframe_insert(data_path="location", frame=frame_start + f)
                arrow.keyframe_insert(data_path="rotation_quaternion", frame=frame_start + f)
                arrow.keyframe_insert(data_path="scale", frame=frame_start + f)
        return com, arrows

    def render_views(out_dir: str, num_frames: int, num_views: int, center, radius,
                     fps: int = 30, resolution=(1280, 720)):
        scene = bpy.context.scene
        scene.render.resolution_x, scene.render.resolution_y = resolution
        scene.render.fps = fps
        scene.frame_start, scene.frame_end = 1, num_frames
        scene.render.image_settings.file_format = "FFMPEG"
        scene.render.ffmpeg.format = "MPEG4"
        for v in range(num_views):
            setup_camera_and_light(center, radius, v, num_views)
            scene.render.filepath = os.path.join(out_dir, f"view{v}.mp4")
            bpy.ops.render.render(animation=True)

    def _render_one_result(kin_dir, bvh_path, sol, character, fbx_path, out_dir,
                           num_views, feet_pos=None, feet_force=None):
        clear_scene()
        setup_floor(os.path.join(kin_dir, "floor_out.txt"))
        import_character(fbx_path=fbx_path, bvh_path=bvh_path,
                         scale=CHARACTER_SCALE.get(character, 1.0))
        draw_com_and_forces(sol, feet_pos=feet_pos, feet_force=feet_force)
        center = Vector(tuple((-sol.base_pos.mean(axis=0))[[0, 2, 1]]))
        radius = float(max(sol.base_pos.max(0) - sol.base_pos.min(0)) + 1.0)
        os.makedirs(out_dir, exist_ok=True)
        render_views(out_dir, sol.base_pos.shape[0], num_views, center, radius)

    def render_multiview_eval(video_dir: str, character: str, fbx_path: str,
                              out_dir: str, num_views: int = 2,
                              kinematic_result: bool = False, fps: float = 30.0):
        """Full render of the best physics result (ref :543-660).

        kinematic_result=True adds the reference's second pass
        (viz_blender.py:637-659): the no_dynamics (kinematic-only) motion
        rendered with a single estimated F=m(a−g) force at the COM — the
        paper's physics-vs-kinematics side-by-side."""
        import numpy as np

        from chd_tpu_torch.characters import get_character
        from chd_tpu_torch.physics.towr_io import load_results

        name = os.path.basename(os.path.abspath(video_dir))
        phys_out = os.path.join(video_dir, f"phys_optim_out_{character}")
        kin = os.path.join(video_dir, "kinematic_results")
        label = pick_result(phys_out)
        bvh_path = os.path.join(phys_out, f"{name}_{character}_{label}.bvh")
        sol = load_results(os.path.join(phys_out, f"sol_out_{label}.txt"))
        _render_one_result(kin, bvh_path, sol, character, fbx_path, out_dir, num_views)

        if kinematic_result:
            kin_bvh = os.path.join(phys_out, f"{name}_{character}_no_dynamics.bvh")
            kin_sol = load_results(os.path.join(phys_out, "sol_out_no_dynamics.txt"))
            with open(os.path.join(kin, "floor_out.txt")) as f:
                normal = [float(x) for x in f.readline().split()]
            est_force = estimate_kinematic_forces(
                kin_sol.base_pos, normal, get_character(character).mass, fps
            )
            # the reference draws the estimated force at the per-frame mean
            # of the four kinematic feet, not at the COM (viz_blender.py:
            # 637-665 collapses kinematic_feet_pos with a mean over feet)
            feet_mean = np.mean(
                np.asarray(kin_sol.feet_pos), axis=1
            ).reshape(-1, 1, 3)
            _render_one_result(
                kin, kin_bvh, kin_sol, character, fbx_path,
                os.path.join(out_dir, "kinematic"), num_views,
                feet_pos=feet_mean, feet_force=est_force,
            )


def main(argv=None):
    if not HAVE_BPY:
        raise SystemExit(
            "chd_tpu_torch.viz.blender must run inside Blender: blender -b -P <this file> -- ..."
        )
    if argv is None:
        argv = sys.argv[sys.argv.index("--") + 1 :] if "--" in sys.argv else []
    ap = argparse.ArgumentParser()
    ap.add_argument("--video-dir", required=True)
    ap.add_argument("--character", default="ybot")
    ap.add_argument("--fbx", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--views", type=int, default=2)
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.video_dir, "render_out")
    render_multiview_eval(args.video_dir, args.character, args.fbx, out, args.views)


if __name__ == "__main__":
    main()
