"""The plain reference (PyTorch and numpy, float32, TF32 off) and the yardstick (peaks, work from shapes, the
comparisons). Nothing here imports the port or JAX.

A model family and a training recipe are modules found by name, so that a
configuration of another family, or a training traffic of another recipe,
is added as files alone:

- a configuration's ``"family": "<f>"`` names ``<f>.py``, which gives
  ``PORT_MODEL`` (the port's class of the family, ``module:attribute``:
  named, not imported; the faults plant in it), ``param_shapes(config)``
  (the port's names, in the order of the seed's draw), ``init(name, u,
  gain, shapes)`` (a parameter from its share ``u`` of the uniform draw in
  [-1, 1)), ``forward(params, config, feats, bn=None, rounding=None,
  stats=None)``, ``eval_state(params, config, feats)`` (what the eval
  forward takes as ``bn``) and ``model_flops(config)``;
- a training traffic's ``"recipe": "<r>"`` names ``recipe_<r>.py``, which
  gives ``PORT_OPTIMIZER`` (the port's optimizer class, whose ``apply`` a
  fault replaces), ``port_optimizer(port)`` (the port's optimizer as the
  program builds it; ``port`` resolves a ``module:attribute`` name),
  ``first_gradient(optimizer, param, param0)`` (a parameter's first
  gradient as the optimizer got it, read from its state after one step) and
  ``steps(params0, config, batches, feats_of, forward, rounding=None,
  rows=None, divisor=None)``, the reference's steps (``rows`` and
  ``divisor`` plant a step that reads part of its batch).
"""

FAMILY = ("PORT_MODEL", "param_shapes", "init", "forward", "eval_state", "model_flops")
RECIPE = ("PORT_OPTIMIZER", "port_optimizer", "first_gradient", "steps")
