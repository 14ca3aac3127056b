"""The generators of traffic, one file each, found by the name a mix gives.

A mix (``mixes/<traffic>.json``) is data: it names its ``generator`` here
and the parameters that generator reads. A generator module offers
``make(mix, cfg, panel, device, seed)``, which returns an object with

* ``params`` — the arguments its calls take, handed to the reference;
* ``call()`` — one call of the system under test → its output;
* ``units(out)`` — the work of one call in the mix's units;
* ``window(win, t0, seconds)`` — the window's loop: it drives
  ``win.call()`` until ``seconds`` have passed since ``t0``;
* ``end_to_end(win, window_s)`` — the end-to-end metrics of the window
  by name (``setup_s`` aside, which the harness takes);
* ``close()`` — drop the system's state before the output check.

So a later mix of another kind (drawn arguments, a fresh run directory a
call, an open loop at a fixed rate with its latency) is a new generator
file beside a new mix file, and edits none.
"""
