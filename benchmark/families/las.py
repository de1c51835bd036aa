"""The ``las`` family: Listen-Attend-Spell with a (pyramidal) LSTM listener on
the features as they come and an LSTM speller with dot-product attention
(``configs/base-las.json``). The family of every configuration that names
none.

A family is what a run needs to know of the model's architecture; the entry
(``entries/train.py``) and ``calibrate.py`` reach it through
``harness.family`` and nothing else:

  ``leaf_specs(model)``           the leaves ``weights.make_flat`` draws;
  ``feature_width(model)``        the features a frame ``mixes.make_batch`` draws;
  ``dropout_rates(model)``        the listener layers' dropout rates, for
                                  ``draw_step``'s masks;
  ``train_steps``, ``precision``, ``control_precision``
                                  the plain reference's checked steps, its
                                  precision, and the control's below the
                                  configuration's;
  ``train_step_flops``, ``train_step_launches``
                                  a batch's model FLOPs (``mfu.train``) and the
                                  port's kernel launches on it (the rooflines).
"""

from benchmark import counts, weights
from benchmark.reference import las_ref

leaf_specs = weights.leaf_specs
train_steps = las_ref.train_steps
precision = las_ref.precision
control_precision = las_ref.control_precision
train_step_flops = counts.train_step_flops
train_step_launches = counts.train_step_launches


def feature_width(model: dict) -> int:
    return model["listener_configs"]["input_dim"]


def dropout_rates(model: dict) -> list:
    return [rate for _, _, rate in las_ref.listener_layers(model)]
