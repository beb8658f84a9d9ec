"""Debug files written by ``ICP.align``.

Port of ``mp2p_icp_tpu/io/debug_dump.py`` (reference: Parameters.h:66-96,
the ``generateDebugFiles`` family, and ICP.cpp:384-467,
``ICP::save_log_file``): with ``ICPParameters.generate_debug_files`` every
align writes a log record (``io/icplog.py``) to a file named from
``debug_file_name_format``, where ``$UNIQUE_ID`` (a process-wide counter),
``$GLOBAL_ID`` / ``$GLOBAL_LABEL`` and ``$LOCAL_ID`` / ``$LOCAL_LABEL``
(the maps' metadata) are substituted; ``decimation_debug_files`` keeps one
file of N, ``decimation_iteration_details`` one recorded iteration of N,
and the two functors may replace or shrink the maps before they are
written.
"""

from __future__ import annotations

import os
import threading

import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.io.icplog import save_log

_counter_lock = threading.Lock()
_log_file_counter = 0


def reset_unique_id_counter(value: int = 0) -> None:
    """Reset the process-wide $UNIQUE_ID counter."""
    global _log_file_counter
    with _counter_lock:
        _log_file_counter = value


def _id_label(mm):
    """(id, label) of a MetricMap; a dict of layers has neither (the
    reference substitutes 0 / '', ICP.cpp:410-441)."""
    mid = getattr(mm, "id", None)
    return (int(mid) if mid is not None else 0), (getattr(mm, "label", None) or "")


def format_debug_filename(fmt: str, unique_id: int, local_mm, global_mm) -> str:
    """Substitute the reference's file-name template variables
    (ICP.cpp:403-441)."""
    lid, llabel = _id_label(local_mm)
    gid, glabel = _id_label(global_mm)
    return (fmt.replace("$UNIQUE_ID", f"{unique_id:05d}")
            .replace("$GLOBAL_ID", f"{gid:05d}").replace("$GLOBAL_LABEL", glabel)
            .replace("$LOCAL_ID", f"{lid:05d}").replace("$LOCAL_LABEL", llabel))


def _decimate_iteration_details(results, n: int):
    """Keep 1 of n recorded iterations (Parameters.h:79-83)."""
    if n <= 1 or results.iteration_poses is None:
        return results

    def every_nth(tree):
        return None if tree is None else pytree.tree_map(
            lambda x: x[::n] if getattr(x, "ndim", 0) >= 1 else x, tree)

    return results._replace(
        iteration_poses=every_nth(results.iteration_poses),
        iteration_pair_counts=every_nth(results.iteration_pair_counts),
        iteration_pairings=every_nth(results.iteration_pairings),
    )


def _apply_functor(fn, mm):
    """A functor may change the map in place (the reference's) or return a
    replacement; None keeps the (possibly changed) input."""
    if fn is None:
        return mm
    out = fn(mm)
    return mm if out is None else out


def save_icp_debug_file(params, local_mm, global_mm, guess, results):
    """``ICP::save_log_file``: the path written, or None when
    ``decimation_debug_files`` skips this align."""
    global _log_file_counter
    with _counter_lock:
        unique_id = _log_file_counter
        _log_file_counter += 1
    if params.decimation_debug_files > 1 and unique_id % params.decimation_debug_files != 0:
        return None  # ICP.cpp:398-400

    filename = format_debug_filename(params.debug_file_name_format, unique_id,
                                     local_mm, global_mm)
    base_dir = os.path.dirname(filename)
    if base_dir:
        os.makedirs(base_dir, exist_ok=True)  # ICP.cpp:443-459
    save_log(
        filename,
        _apply_functor(params.functor_before_logging_local, local_mm),
        _apply_functor(params.functor_before_logging_global, global_mm),
        guess,
        _decimate_iteration_details(results, params.decimation_iteration_details),
    )
    return filename
