"""The plain reference of every cell's output check.

Plain PyTorch, written from the EDM definitions (Sugihara et al. 2012;
kEDM, Takahashi et al. 2021) and the port's documented conventions, and
independent of the program: it imports nothing of ``repro_torch`` or of
the JAX package and takes only the panel the benchmark made. It works the
delay embeddings, neighbours, weights and fits out again from that panel.

Each check module (``simplex_xmap``, ``edim``) offers

* ``keep(out, sample)`` — the part of one call's output that is checked;
* ``expected(panel, sample, params, *, device, precision)`` — the same
  part worked out by the reference, at ``precision`` ``"float64"`` (the
  reference) or ``"tf32"`` (the control: float32 with TF32 products);
* ``as_output(part, sample, n)`` — such a part in the place of a whole
  call's output (how the control is put in the program's place);
* ``readings(kept, ref)`` — the numbers compared, each against the limit
  of the same name in ``checks/<cell>.json``.
"""

import importlib


def module(name: str):
    """The check module ``edmbench.reference.<name>``."""
    return importlib.import_module(f"edmbench.reference.{name}")
