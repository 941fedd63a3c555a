"""Real-robot UDP link: ctypes binding over the native C++ layer.

API parity with the reference's CassieUdp wrapper
(cassie/cassiemujoco/cassiemujoco.py:404-482): send_pd / recv_newest /
delay / seq_num_in_diff, plus the robot-side counterpart used by the
policy-serving loop. Payload layout documented in native/cassie_udp.cpp.

The native library is built lazily with `make -C native` on first use.

A copy of `apex_tpu/runtime/udp_link.py` (numpy and ctypes only): it reads
the same `native/libapex_udp.so` at the root of the repository, rebuilt
with `make -C native` when its source is newer, and packs the Agility
framing with the port's `runtime/agility_wire.py`.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB = None

PD_FLOATS = 50      # pTarget, dTarget, pGain, dGain, ff x 10
STATE_FLOATS = 73


class _HeaderInfo(ctypes.Structure):
    _fields_ = [("seq_num_out", ctypes.c_uint8),
                ("seq_num_in_last", ctypes.c_uint8),
                ("delay", ctypes.c_int),
                ("seq_num_in_diff", ctypes.c_int)]


def _lib():
    global _LIB
    if _LIB is None:
        path = os.path.join(_NATIVE_DIR, "libapex_udp.so")
        src = os.path.join(_NATIVE_DIR, "cassie_udp.cpp")
        stale = (not os.path.exists(path)
                 or (os.path.exists(src)
                     and os.path.getmtime(src) > os.path.getmtime(path)))
        if stale:
            subprocess.check_call(["make", "-C", _NATIVE_DIR, "-s", "-B"])
        lib = ctypes.CDLL(path)
        lib.apex_udp_init_host.restype = ctypes.c_int
        lib.apex_udp_init_host.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
        lib.apex_udp_init_client.restype = ctypes.c_int
        lib.apex_udp_init_client.argtypes = [
            ctypes.c_char_p, ctypes.c_uint16, ctypes.c_char_p,
            ctypes.c_uint16]
        lib.apex_send_pd.argtypes = [
            ctypes.c_int, ctypes.POINTER(_HeaderInfo),
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint8]
        lib.apex_send_state.argtypes = [
            ctypes.c_int, ctypes.POINTER(_HeaderInfo),
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint8]
        lib.apex_recv_newest_pd.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.apex_recv_newest_state.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.apex_wait_for_packet.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.apex_send_raw.argtypes = [
            ctypes.c_int, ctypes.POINTER(_HeaderInfo),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_uint8]
        lib.apex_recv_newest_raw.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.apex_udp_close.argtypes = [ctypes.c_int]
        lib.apex_udp_close.restype = None
        for name in ("apex_send_pd", "apex_send_state", "apex_recv_newest_pd",
                     "apex_recv_newest_state", "apex_wait_for_packet",
                     "apex_send_raw", "apex_recv_newest_raw"):
            getattr(lib, name).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _send_raw(sock, info, last_seq_in, payload: bytes) -> int:
    buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
    return _lib().apex_send_raw(sock, ctypes.byref(info), buf, len(payload),
                                last_seq_in.value)


def _recv_raw(sock, last_seq_in, size: int):
    buf = (ctypes.c_uint8 * size)()
    n = _lib().apex_recv_newest_raw(sock, buf, size,
                                    ctypes.byref(last_seq_in))
    return bytes(buf[:n]) if n >= size else None


class CassieUdp:
    """Operator-side link (reference CassieUdp, cassiemujoco.py:404-482):
    sends PD commands, receives state packets."""

    def __init__(self, remote_addr="10.10.10.3", remote_port=25000,
                 local_addr="0.0.0.0", local_port=25001):
        lib = _lib()
        self.sock = lib.apex_udp_init_client(
            remote_addr.encode(), remote_port, local_addr.encode(),
            local_port)
        if self.sock < 0:
            raise OSError("udp client init failed")
        self.info = _HeaderInfo(0, 0, 0, 0)
        self._last_seq_in = ctypes.c_uint8(0)

    def send_pd(self, pd: np.ndarray):
        pd = np.ascontiguousarray(pd, dtype=np.float32)
        assert pd.size == PD_FLOATS
        _lib().apex_send_pd(
            self.sock, ctypes.byref(self.info),
            pd.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._last_seq_in.value)

    def recv_newest(self):
        """Latest state packet as a (STATE_FLOATS,) array, or None."""
        out = np.zeros(STATE_FLOATS, dtype=np.float32)
        n = _lib().apex_recv_newest_state(
            self.sock, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(self._last_seq_in))
        return out if n >= STATE_FLOATS else None

    def wait(self, timeout_ms=1000):
        return _lib().apex_wait_for_packet(self.sock, timeout_ms) > 0

    # ---- Agility-compatible wire format (reference send_pd/recv_newest_pd,
    # cassiemujoco.py:428-482: 2-byte header + pd_in_t 476 B out,
    # state_out_t 493 B in) ----
    def send_pd_t(self, pd) -> None:
        """pd: agility_wire.PdIn (or a flat [left5, right5] target array)."""
        from apex_tpu_torch.runtime import agility_wire as aw

        if not isinstance(pd, aw.PdIn):
            pd = aw.PdIn.from_targets(pd)
        _send_raw(self.sock, self.info, self._last_seq_in, aw.pack_pd_in(pd))

    def recv_newest_pd_t(self):
        """Latest state_out_t as agility_wire.StateOut, or None."""
        from apex_tpu_torch.runtime import agility_wire as aw

        data = _recv_raw(self.sock, self._last_seq_in,
                         aw.STATE_OUT_PACKED_LEN)
        return None if data is None else aw.unpack_state_out(data)

    @property
    def delay(self):
        return self.info.delay

    @property
    def seq_num_in_diff(self):
        return self.info.seq_num_in_diff

    def close(self):
        _lib().apex_udp_close(self.sock)


class RobotSideLink:
    """Robot/simulator-side counterpart: receives PD commands, sends state
    packets (the role the firmware plays)."""

    def __init__(self, local_addr="0.0.0.0", local_port=25000,
                 remote_addr="127.0.0.1", remote_port=25001):
        lib = _lib()
        self.sock = lib.apex_udp_init_client(
            remote_addr.encode(), remote_port, local_addr.encode(),
            local_port)
        if self.sock < 0:
            raise OSError("udp host init failed")
        self.info = _HeaderInfo(0, 0, 0, 0)
        self._last_seq_in = ctypes.c_uint8(0)

    def recv_newest_pd(self):
        out = np.zeros(PD_FLOATS, dtype=np.float32)
        n = _lib().apex_recv_newest_pd(
            self.sock, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(self._last_seq_in))
        return out if n >= PD_FLOATS else None

    def send_state(self, state: np.ndarray):
        state = np.ascontiguousarray(state, dtype=np.float32)
        assert state.size == STATE_FLOATS
        _lib().apex_send_state(
            self.sock, ctypes.byref(self.info),
            state.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._last_seq_in.value)

    def recv_newest_pd_agility(self):
        """Latest pd_in_t (476 B payload) as agility_wire.PdIn, or None."""
        from apex_tpu_torch.runtime import agility_wire as aw

        data = _recv_raw(self.sock, self._last_seq_in, aw.PD_IN_PACKED_LEN)
        return None if data is None else aw.unpack_pd_in(data)

    def send_state_t(self, state_out) -> None:
        """state_out: agility_wire.StateOut (pack_state_out_t framing)."""
        from apex_tpu_torch.runtime import agility_wire as aw

        _send_raw(self.sock, self.info, self._last_seq_in,
                  aw.pack_state_out(state_out))

    def wait(self, timeout_ms=1000):
        return _lib().apex_wait_for_packet(self.sock, timeout_ms) > 0

    def close(self):
        _lib().apex_udp_close(self.sock)
