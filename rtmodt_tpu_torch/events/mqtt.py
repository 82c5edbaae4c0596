"""A minimal MQTT 3.1.1 publisher (QoS 0) over a plain socket.

The port's own copy of ``rtmodt_tpu/events/mqtt.py``: the ``mqtt`` alert
backend of the zone engine without a client package.  CONNECT / CONNACK /
PUBLISH / DISCONNECT are a few dozen bytes of framing each (OASIS MQTT 3.1.1,
sections 3.1, 3.2, 3.3 and 3.14), sent byte for byte as the reference sends
them.

QoS 0 is fire-and-forget: the events JSONL is the durable record, MQTT the
live channel.  The publisher connects on the first publish and, after a
failure, reconnects on a later publish once a back-off has passed.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from rtmodt_tpu_torch.utils.logging import logger


def _encode_remaining_length(n: int) -> bytes:
    """MQTT's variable-length remaining-length encoding (spec 2.2.3)."""
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


class MQTTPublisher:
    """QoS-0 publisher: lazy connect, publish, reconnect after an error."""

    def __init__(self, host: str, port: int = 1883,
                 client_id: str = "rtmodt-tpu", keepalive: int = 0,
                 timeout: float = 2.0):
        # keepalive 0 turns the broker's idle timeout off (3.1.2.10): this
        # publisher sends no PINGREQ, so a non-zero keepalive would get an
        # idle connection dropped and the next publish lost in the dead
        # socket's buffer
        self.host = host
        self.port = port
        self.client_id = client_id
        self.keepalive = keepalive
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        # with the broker unreachable every publish would block the caller
        # for the connect timeout; after a failure, publishes are dropped
        # until the back-off has passed
        self.reconnect_backoff_sec = 5.0
        self._next_connect_ok = 0.0

    def _connect(self) -> None:
        sock = socket.create_connection((self.host, self.port), self.timeout)
        try:
            sock.settimeout(self.timeout)
            # variable header: protocol name "MQTT", level 4, clean session
            vh = _utf8("MQTT") + bytes([4, 0x02]) + struct.pack(">H", self.keepalive)
            payload = _utf8(self.client_id)
            sock.sendall(bytes([0x10]) + _encode_remaining_length(len(vh) + len(payload))
                         + vh + payload)
            ack = b""
            while len(ack) < 4:          # CONNACK may arrive split across segments
                chunk = sock.recv(4 - len(ack))
                if not chunk:
                    break
                ack += chunk
            if len(ack) < 4 or ack[0] != 0x20 or ack[3] != 0x00:
                raise ConnectionError(f"MQTT CONNACK refused: {ack.hex() if ack else 'EOF'}")
        except BaseException:
            sock.close()
            raise
        self._sock = sock

    def publish(self, topic: str, payload: bytes | str) -> bool:
        """QoS-0 PUBLISH; False (the message dropped) on a transport error."""
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        body = _utf8(topic) + payload
        packet = bytes([0x30]) + _encode_remaining_length(len(body)) + body
        with self._lock:
            try:
                if self._sock is None:
                    if time.monotonic() < self._next_connect_ok:
                        return False   # inside the back-off: drop quietly
                    self._connect()
                self._sock.sendall(packet)
                return True
            except OSError as e:
                self._next_connect_ok = time.monotonic() + self.reconnect_backoff_sec
                logger.warning(f"mqtt publish failed ({e}); next reconnect attempt in "
                               f"{self.reconnect_backoff_sec:.0f}s")
                self.close()
                return False

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.sendall(bytes([0xE0, 0x00]))   # DISCONNECT
            except OSError:
                pass
            try:
                self._sock.close()
            finally:
                self._sock = None
