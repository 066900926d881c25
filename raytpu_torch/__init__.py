"""raytpu_torch — raytpu's path tracer in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100.

A port of the JAX package ``raytpu`` (which stays the reference): glTF/GLB
scenes and an optional JSON look-at camera in, path-traced PNG out, with
the same RNG stream, the same reference quirks and the same triangle on
every hit. It imports torch and numpy, never JAX or raytpu.

Typical use:

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.camera import load_camera_json
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.types import RenderConfig
    from raytpu_torch.io.png import write_png

    scene = load_scene("cube.glb")
    cam = load_camera_json("camera.json", 512, 512)
    cfg = RenderConfig(width=512, height=512, seed=1, samples=16,
                       bounces=4, chunk_size=64)
    frame = render_frame(pack_scene(scene, "cuda"),
                         pack_camera(cam, "cuda"), cfg)  # [H,W,4] f32
    write_png("out.png", frame)
"""

__version__ = "0.1.0"
