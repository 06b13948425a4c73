"""Chained threshold time-point cascade in one kernel (the port of
``dspeed_tpu/processors/tp_chain.py``).

The canonical HPGe timing block (the LEGEND icpc config, reference
``tests/configs/icpc-dsp-config.json``) computes its rise-time points as a
cascade of :func:`.time_point_thresh` calls: ``tp_100``/``tp_99`` walk
forward from ``tp_0_est``, then each lower threshold walks backward from the
previous time point. :func:`chained_time_point_thresh` takes the whole
cascade structure and returns one kernel computing every time point: kernel
K2 (``_cuda.cascade_tp``) on the card, its plain link-by-link version on the
CPU. Each link keeps :func:`.time_point_thresh`'s crossing predicates and
NaN rules, so the outputs are bit-identical to the separate calls.
"""

from __future__ import annotations

from ._cuda import _cascade_links, cascade_tp
from ._kernel import Kernel

__all__ = ["chained_time_point_thresh"]


def chained_time_point_thresh(factors, walk_forward, start_from) -> Kernel:
    """Build a kernel computing a cascade of threshold time points.

    Parameters
    ----------
    factors
        length-``m`` sequence; threshold ``k`` is ``factors[k] * a_base``.
    walk_forward
        length-``m`` sequence of 0/1 walk directions (as in
        :func:`.time_point_thresh`).
    start_from
        length-``m`` sequence; entry ``k`` is ``-1`` to start search ``k``
        from ``t_start``, or ``j < k`` to start from time point ``j``'s
        result (the cascade link).

    Returns a kernel ``(w_in, a_base, t_start) -> (tp_0, ..., tp_{m-1})``.
    """
    factors, dirs, starts = _cascade_links(factors, walk_forward, start_from)
    m = len(factors)

    def fn(w_in, a_base, t_start, badrow=None):
        return cascade_tp(w_in, a_base, t_start, factors, dirs, starts, badrow)

    sig = "(n),(),()->" + ",".join(["()"] * m)
    types = ["f" * 3 + "->" + "f" * m, "d" * 3 + "->" + "d" * m]
    return Kernel(
        fn, sig, types, name="chained_time_point_thresh", badrow_arg=0
    )
