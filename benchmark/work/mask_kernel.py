"""The work of the repeat mask (``mask_kernel``, ``csrc/tantan.cu``): the
tantan-equivalent forward-backward recurrence over every base of every
read that reaches the filter (each input read is masked), at each of the
``mask_max_period`` repeat periods.

Operations a base and period, as the recurrence needs them
(``fslr_tpu_torch/ops/tantan.py``'s plain version, with the per-position
normalisation left out, as the kernel leaves it out and rescales every 16
positions):

* forward, 5: ``(fr * stay_r + fb * start_d) * er`` is two
  multiplications, an addition and a multiplication, and the sum over
  periods for the background state one addition;
* backward, 7: the posterior's ``fr * br`` and its sum (2), ``er * br``
  (1), ``start_d * w`` and its sum (2), ``stay_r * w + end_p * bb`` (2).

Emission selects are not counted.  Bytes: each base read once (1 byte)
and its posterior written once (4 bytes).  Read lengths, not the padded
batch the program launches (its ``hmm`` counter counts that)."""

OPS_PER_BASE_PERIOD = 12
BYTES_PER_BASE = 5
MASK_MAX_PERIOD = 100      # JunkFilterConfig.mask_max_period, the default


def work(rec) -> dict:
    bases = int(rec.read_lengths.sum())
    return {'ops': OPS_PER_BASE_PERIOD * MASK_MAX_PERIOD * bases,
            'bytes': BYTES_PER_BASE * bases}
