"""The fields a configuration can run (``configs/<name>.json``'s ``field``;
a configuration that names none runs ``nerf_mlp``).

A field is the model behind the traffic kinds: ``kinds/train.py`` and
``kinds/view.py`` drive whatever field the configuration names through the
names of ``INTERFACE``, which ``fields/<field>.py`` defines:

- ``GROUP``: the configuration's group of the field's sizes, which also
  holds the render's ``coarse_samples``, ``fine_samples``, ``near`` and
  ``far``;
- ``weights(seed, cfg, traffic, device)``: the parameter tree the program
  and the reference both start from, made on the device from the seed;
- ``points_per_ray(cfg)``, ``train_flops_per_ray(cfg)``,
  ``render_flops_per_ray(cfg)``: the work of one ray;
- ``train_program(cfg, traffic, focal, params, device)``: the program's
  train step and its optimizer state, ``(step, state)``; ``step(params,
  state[, grid], images, poses, step, seed)`` runs the configuration's
  ``steps_per_call`` steps and returns ``(params, state[, grid],
  metrics)`` with ``metrics["train_loss"]`` and ``["train_coarse_loss"]``
  of the last step; ``state`` holds ``mu``, ``nu`` (trees of the
  parameters' layout) and ``count``;
- ``serve_program(cfg, traffic, params, grid, directory, device)``: the
  program's render chunk for ``minimal_nerf_torch.views``, served from
  what it writes into ``directory``;
- ``reference(cfg)``: the plain reference's ``reference.nerf.Field``;
- ``reference_numerics(cfg)``, ``control_numerics(cfg)``: the numerics
  the output check holds the program to, and the control's, one step
  lower.

The program's modules are imported inside the functions, so the reference
and the weights load without it.
"""

INTERFACE = ("GROUP", "weights", "points_per_ray", "train_flops_per_ray", "render_flops_per_ray",
             "train_program", "serve_program", "reference", "reference_numerics",
             "control_numerics")
