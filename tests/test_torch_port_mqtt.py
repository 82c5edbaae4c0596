"""The ``mqtt`` alert backend: the port's publisher (``events/mqtt.py``)
against the reference's, and the port's zone engine publishing its events.

A broker thread in the test accepts one connection on localhost, answers
CONNECT with CONNACK and keeps every byte it receives.  The port's publisher
and the reference's must send the same bytes for the same calls (CONNECT,
PUBLISH with one-, two- and three-byte remaining lengths, DISCONNECT); the
port's engine must publish every event it writes to its JSONL log, the
payload equal to the line.
"""

from __future__ import annotations

import json
import socket
import threading

import numpy as np
import pytest

from rtmodt_tpu.events import mqtt as jax_mqtt
from rtmodt_tpu_torch.config.loader import AlertConfig
from rtmodt_tpu_torch.events import mqtt
from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine


class Broker:
    """One client on 127.0.0.1: CONNACK after CONNECT, every byte kept until
    the client disconnects or closes."""

    def __init__(self):
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(10.0)
        self.port = self.srv.getsockname()[1]
        self.raw = b""
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self) -> None:
        conn, _ = self.srv.accept()
        conn.settimeout(10.0)
        acked = False
        try:
            while True:
                data = conn.recv(65536)
                if not data:
                    return
                self.raw += data
                if not acked and len(self.raw) >= 2:
                    conn.sendall(bytes([0x20, 0x02, 0x00, 0x00]))
                    acked = True
                if self.raw.endswith(bytes([0xE0, 0x00])):
                    return
        finally:
            conn.close()
            self.srv.close()

    def packets(self) -> list[tuple[int, bytes]]:
        """(packet type, body) of every packet received."""
        self.thread.join(10.0)
        out, buf = [], self.raw
        while buf:
            rl, mult, i = 0, 1, 1
            while True:
                byte = buf[i]
                rl += (byte & 0x7F) * mult
                mult *= 128
                i += 1
                if not byte & 0x80:
                    break
            out.append((buf[0] >> 4, buf[i:i + rl]))
            buf = buf[i + rl:]
        return out


def publishes(packets) -> list[tuple[str, bytes]]:
    out = []
    for ptype, body in packets:
        if ptype == 3:
            n = int.from_bytes(body[:2], "big")
            out.append((body[2:2 + n].decode(), body[2 + n:]))
    return out


@pytest.mark.parametrize("n", [0, 1, 127, 128, 16383, 16384, 2097151, 2097152])
def test_remaining_length_encoding_equals_the_reference(n):
    assert mqtt._encode_remaining_length(n) == jax_mqtt._encode_remaining_length(n)


def test_publisher_sends_the_reference_bytes():
    payloads = ["x" * 5, "é" * 150, json.dumps({"k": "v" * 20000})]
    raw = {}
    for name, cls in (("port", mqtt.MQTTPublisher), ("ref", jax_mqtt.MQTTPublisher)):
        broker = Broker()
        pub = cls("127.0.0.1", broker.port, client_id="cam-7")
        assert all(pub.publish("site/cam7/events", p) for p in payloads)
        pub.close()
        packets = broker.packets()
        assert [t for t, _ in packets] == [1, 3, 3, 3, 14]     # CONNECT .. DISCONNECT
        assert [p.decode() for _, p in publishes(packets)] == payloads
        raw[name] = broker.raw
    assert raw["port"] == raw["ref"]


def test_publisher_drops_quietly_without_a_broker():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    srv.close()                                  # nothing listens there now
    pub = mqtt.MQTTPublisher("127.0.0.1", port, timeout=0.5)
    assert pub.publish("t", "lost") is False
    assert pub.publish("t", "inside the back-off") is False and pub._sock is None


def test_engine_publishes_every_logged_event(tmp_path):
    """Two tracks walk into a dwell-free zone and out again over a chunk of
    12 frames: every event the engine logs is published on the topic."""
    broker = Broker()
    log = tmp_path / "ev.jsonl"
    engine = ZoneEventEngine(
        [{"name": "z", "polygon": [[0, 0], [200, 0], [200, 200], [0, 200]],
          "dwell_time_sec": 0.0, "cooldown_sec": 0.2}],
        alert=AlertConfig(backend="mqtt", log_path=str(log), mqtt_host="127.0.0.1",
                          mqtt_port=broker.port, mqtt_topic="rtmodt/test"),
        clock="stream")
    k, s = 12, 2
    xs = np.arange(k, dtype=np.float32)[:, None] * 40 + np.array([0, 20], np.float32)
    boxes = np.stack([xs, xs, xs + 30, xs + 30], axis=-1)            # (K, S, 4)
    evts = engine.process_chunk(
        np.tile([3, 4], (k, 1)), np.zeros((k, s), np.int32), boxes,
        np.ones((k, s), bool), list(range(1, k + 1)), np.arange(k) / 10.0)
    engine._mqtt.close()
    lines = log.read_text().splitlines()
    assert len(evts) == len(lines) >= 2
    got = publishes(broker.packets())
    assert [t for t, _ in got] == ["rtmodt/test"] * len(lines)
    assert [p.decode() for _, p in got] == lines
