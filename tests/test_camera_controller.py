"""Interactive camera-controller parity: the
quaternion rotate/zoom/pan dynamics of Camera.h:74-122 and the
motion → accumulation-reset flow of InteractiveRenderer.h:241-282."""

import numpy as np
import jax.numpy as jnp

from cudavolumerenderer_tpu.ops.camera import (
    generate_rays,
    make_camera,
    make_camera_look_at,
)
from cudavolumerenderer_tpu.ops.camera_controller import (
    CameraController,
    parse_camera_path,
    quat_from_mat,
    quat_mul,
    quat_to_mat,
)


class TestQuat:
    def test_mat_roundtrip(self):
        rs = np.random.RandomState(0)
        for _ in range(20):
            q = rs.randn(4)
            q = q / np.linalg.norm(q)
            m = quat_to_mat(q)
            # proper rotation
            np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-12)
            assert np.linalg.det(m) > 0
            q2 = quat_from_mat(m)
            # q and -q are the same rotation
            np.testing.assert_allclose(
                quat_to_mat(q2), m, atol=1e-10
            )

    def test_mul_composes(self):
        rs = np.random.RandomState(1)
        a = rs.randn(4); a /= np.linalg.norm(a)
        b = rs.randn(4); b /= np.linalg.norm(b)
        np.testing.assert_allclose(
            quat_to_mat(quat_mul(a, b)),
            quat_to_mat(a) @ quat_to_mat(b),
            atol=1e-12,
        )


class TestCameraController:
    def test_default_pose_matches_make_camera(self):
        ctl = CameraController(32, 32, fov_x_deg=0.7)
        cam = ctl.camera()
        ref = make_camera(32, 32, 0.7)
        np.testing.assert_allclose(
            np.asarray(cam.inv_view), np.asarray(ref.inv_view), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(cam.raster_to_view),
            np.asarray(ref.raster_to_view),
        )

    def test_rotate_orbits_center(self):
        """lazyRotateAroundTheCenterBy: position moves on a sphere
        around the origin, radius preserved."""
        ctl = CameraController(100, 100)
        r0 = np.linalg.norm(ctl.position)
        poses = []
        for _ in range(10):
            ctl.rotate(40.0, 15.0)
            poses.append(ctl.position.copy())
            assert abs(np.linalg.norm(ctl.position) - r0) < 1e-9
        # and it actually moved
        assert np.linalg.norm(poses[-1] - poses[0]) > 1.0
        # orientation stays a unit quaternion
        assert abs(np.linalg.norm(ctl.orientation) - 1.0) < 1e-12

    def test_zoom_moves_along_view_axis(self):
        """lazyMoveBy z: 5x multiplier, straight toward the center from
        the default pose."""
        ctl = CameraController(100, 100)
        p0 = ctl.position.copy()
        ctl.zoom(10.0, 0.0)  # dz = 10/100 = 0.1 -> 0.5 world units
        dp = ctl.position - p0
        # default view axis is -z (camera at +z looking at origin);
        # moving by +z in view space recedes... sign fixed by reference
        # formula: t.z += 5*dz, position = R @ (-t), R=diag(1,-1,-1)
        np.testing.assert_allclose(dp, [0.0, 0.0, 0.5], atol=1e-9)

    def test_pan_moves_in_image_plane(self):
        ctl = CameraController(100, 100)
        p0 = ctl.position.copy()
        ctl.pan(10.0, -20.0)
        dp = ctl.position - p0
        # t += (0.1, -0.2, 0); position = R@(-t) with R = diag(1,-1,-1)
        np.testing.assert_allclose(dp, [-0.1, -0.2, 0.0], atol=1e-9)

    def test_look_at_matches_make_camera_look_at_and_composes(self):
        eye, center, up = (30.0, 40.0, 50.0), (0.0, 0.0, 0.0), (0, 1, 0)
        ctl = CameraController(64, 64, fov_x_deg=0.7)
        ctl.look_at(eye, center, up)
        cam = ctl.camera()
        ref = make_camera_look_at(eye, center, up, 64, 64, 0.7)
        np.testing.assert_allclose(
            np.asarray(cam.inv_view), np.asarray(ref.inv_view), atol=1e-5
        )
        # motion composes with the pose instead of snapping (the
        # documented fix over the reference's orientation reset)
        r0 = np.linalg.norm(ctl.position)
        ctl.rotate(25.0, 10.0)
        assert abs(np.linalg.norm(ctl.position) - r0) < 1e-6

    def test_dirty_flag_handshake(self):
        ctl = CameraController(10, 10)
        assert not ctl.consume_dirty()
        ctl.rotate(1, 1)
        ctl.zoom(1, 0)
        assert ctl.consume_dirty()  # one reset per motion batch
        assert not ctl.consume_dirty()

    def test_rotated_camera_renders_rays_toward_center(self):
        """Rays generated from a rotated pose still aim at the volume:
        the central ray direction equals center - position (normalized)."""
        from cudavolumerenderer_tpu.ops.rng import make_rng

        ctl = CameraController(9, 9)
        ctl.rotate(120.0, 60.0)
        cam = ctl.camera()
        rng = make_rng(1, jnp.arange(1, dtype=jnp.uint32))
        pix = jnp.asarray([[4.0, 4.0]])  # center pixel of 9x9
        o, d, _ = generate_rays(
            cam, pix, (9, 9), rng, active=jnp.ones(1, bool)
        )
        o, d = np.asarray(o)[0], np.asarray(d)[0]
        np.testing.assert_allclose(o, ctl.position, atol=1e-4)
        want = -o / np.linalg.norm(o)
        # half-pixel jitter: generous tolerance on direction
        assert np.dot(d, want) > 0.999


class TestCameraPathReplay:
    def test_parse(self):
        ev = parse_camera_path(
            "# demo\nrotate 10 5\nzoom 3 0\npan 1 2\n"
            "lookat 0 0 80 0 0 0\nrender 2\n"
        )
        assert [e[0] for e in ev] == [
            "rotate", "zoom", "pan", "lookat", "render"
        ]
        assert ev[-1][1] == [2]

    def test_cli_replay_resets_accumulation(self, tmp_path, capsys):
        """End-to-end: motion events between renders reset the
        progressive accumulation (reference reset() semantics), still
        dumping one frame per render event."""
        from cudavolumerenderer_tpu import cli
        from cudavolumerenderer_tpu.scene import procedural

        raw = tmp_path / "blob.raw"
        procedural.write_raw_uchar(str(raw), procedural.blob_volume())
        script = tmp_path / "path.txt"
        script.write_text(
            "render 2\nrotate 30 10\nrender 1\nzoom 5 0\nrender 1\n"
        )
        out = tmp_path / "frame"
        rc = cli.main(
            [
                str(raw), "--interactive", "1",
                "--camera-path", str(script),
                "-i", "4", "-r", "8", "8", "-k", "naiveSK",
                "-o", str(out), "--platform", "cpu",
            ]
        )
        assert rc == 0
        txt = capsys.readouterr().out
        assert txt.count("accumulation reset") == 2
        # frame 1 accumulated 2 iterations; frames 2-3 restarted at 1
        assert "path frame 1 dumped (2 it)" in txt
        assert "path frame 2 dumped (1 it)" in txt
        assert "path frame 3 dumped (1 it)" in txt
        for i in (1, 2, 3):
            assert (tmp_path / f"frame_path{i:04d}.png").exists()
