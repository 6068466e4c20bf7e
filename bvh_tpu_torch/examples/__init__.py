"""The repository's five examples (``examples/*.py``) on the port: the same
workflows, arguments and defaults, run on the card unless ``--cpu`` is
given (then on the CPU through the kernels' plain versions, at the
originals' size caps). Each module has ``main(argv=None) -> dict``, which
prints what the original prints and returns those numbers and its checks'
values, and runs as ``python -m bvh_tpu_torch.examples.<name>``:

* ``nearest_query``: nearest triangle to scattered points, kernel path and
  the general path, against brute force;
* ``camera_tracer``: a depth image of the dense mesh through
  ``make_tracer`` in 32x32 tiles, and a free-ray tracer with the key plan;
* ``obj_render``: a generated OBJ colonnade loaded, built, rendered and
  differentiated (one vertex-gradient step);
* ``dynamic_scene``: build once, move triangles every frame, trace the
  updater's chained scene, compare with a rebuild;
* ``pathtrace``: the wavefront path tracer over a floor and six cubes.
"""
