"""Threaded streaming pipeline: a producer feeding frames, a consumer
draining the engine.

Counterpart of ``videollm_online_tpu/serve/pipeline.py``. The reference
paper claims parallelized encoding/decoding but its released loop is
sequential (SURVEY.md §2.3, demo/inference.py). Here a producer thread
feeds (and, with a vision tower, encodes) incoming frames and the consumer
loop drains the engine. Queue discipline is explicit:

  * the producer only touches ``engine.input_video_stream`` /
    ``input_query_stream`` under ``lock``;
  * the consumer only calls ``engine()`` under the same lock — the deques
    themselves are engine-internal state;
  * ``stop()`` joins the producer; pending events drain before exit;
  * CUDA work is ordered on one stream: torch's current stream belongs to
    each thread, so the producer launches on the stream that was current
    in the thread that started it (the consumer's), and the embeddings it
    queues are finished before the consumer's forwards read them.

Events stream to ``on_event(query, response)`` as they are produced."""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch


class StreamingPipeline:
    def __init__(self, engine, *, on_event: Optional[Callable] = None,
                 realtime: bool = False):
        self.engine = engine
        self.on_event = on_event
        self.realtime = realtime
        self.lock = threading.Lock()
        self.events: List[Tuple[Optional[str], str]] = []
        self._stop = threading.Event()
        self._producer: Optional[threading.Thread] = None

    # ------------------------------------------------------------- producer
    def start_video(self, duration_s: float, *,
                    tick_s: Optional[float] = None):
        """Feed engine.input_video_stream from a background thread at the
        frame-grid pace (wall-clock when ``realtime``)."""
        fps = self.engine.frame_fps
        tick = tick_s if tick_s is not None else 1.0 / fps
        streams = [torch.cuda.current_stream(d) for d in
                   {self.engine.device, self.engine.encoder_device}
                   if d.type == "cuda"]

        def run():
            with contextlib.ExitStack() as on_streams:
                for s in streams:
                    on_streams.enter_context(torch.cuda.stream(s))
                t = 0.0
                while t <= duration_s and not self._stop.is_set():
                    with self.lock:
                        self.engine.input_video_stream(t)
                    if self.realtime:
                        time.sleep(tick)
                    t += 1.0 / fps

        self._producer = threading.Thread(target=run, daemon=True)
        self._producer.start()

    def submit_query(self, query: str, video_time: Optional[float] = None):
        with self.lock:
            self.engine.input_query_stream(query, video_time=video_time)

    # ------------------------------------------------------------- consumer
    def drain(self, max_idle_rounds: int = 3, idle_sleep: float = 0.002
              ) -> List[Tuple[Optional[str], str]]:
        """Consume until the producer is done and the queues are empty."""
        idle = 0
        while True:
            with self.lock:
                q, r = self.engine()
                queue_empty = not self.engine.frame_embeds_queue
            if r is not None:
                self.events.append((q, r))
                if self.on_event:
                    self.on_event(q, r)
                idle = 0
                continue
            producer_alive = (self._producer is not None
                              and self._producer.is_alive())
            if queue_empty and not producer_alive:
                idle += 1
                if idle >= max_idle_rounds:
                    return self.events
            time.sleep(idle_sleep)

    def stop(self):
        self._stop.set()
        if self._producer is not None:
            self._producer.join(timeout=5)
