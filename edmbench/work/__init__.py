"""Operations and bytes of each stage, as functions of the shapes.

One file a stage; each ``work(**shape)`` takes the call's shape — ``N``
series of length ``L``, lag ``tau``, horizon ``Tp``, and ``E``, ``E_max``
or ``launches`` (library batches a call) where the stage has them — and
returns the work of one call as a dict of

* ``fp32`` — float32 operations the algorithm needs (a multiply-add is
  two; a comparison, square root, division or exponential one each);
* ``tf32`` — operations of products whose float32 contract allows the
  3×TF32 split (as an S-Map Gram's may), held to the TF32 peak;
* ``bytes`` — what the stage's launches read and write: each input byte
  read once a launch, each output byte written once, whatever a kernel
  reads again (the kernel rooflines);
* ``io_bytes`` — the part of it that crosses the call's boundary: the
  panel read once and the result written once (the whole-call roofline,
  where fusing stages removes the tables passed between them).

Work is counted from the shapes, whatever implements it: a distance is
counted once a pair (it is symmetric), a selection one comparison a
candidate, and padded rows of a ragged last batch are not counted.
"""
