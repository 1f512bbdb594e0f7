"""S cameras, each step the next frame of every camera (each from its own
pool offset): the port's ``BatchedStreamingServer`` at the traffic's depth
over ``MultiStreamProcessor``, closed loop (the next step is fed as soon as
``feed`` returns). ``frame_ms`` holds each step's host time from its feed
to the return of the call that handed its answers back; the window closes
once every step fed in it has retired."""

import time

import numpy as np

from benchmark.harness.serve import Loop as _Loop
from benchmark.harness.trace import span


class Loop(_Loop):
    def build(self, cfg, device):
        from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor

        return MultiStreamProcessor(cfg, segmenter=self.segmenter, device=device)

    def serve(self, seconds: float) -> float:
        from vision_assist_tpu_torch.pipeline.server import BatchedStreamingServer

        msp, clock = self.processor, time.perf_counter
        streams = self.traffic["streams"]
        submit, retire = msp.submit_frames, msp.retire_frames

        def timed_submit(frames):
            t0 = clock()
            with span("submit"):
                out = submit(frames)
            self.spans["submit"].append(clock() - t0)
            return out

        def timed_retire(handle, now_ms=0):
            t0 = clock()
            with span("retire"):
                out = retire(handle, now_ms)
            self.spans["retire"].append(clock() - t0)
            return out

        msp.submit_frames, msp.retire_frames = timed_submit, timed_retire
        server = BatchedStreamingServer(msp, depth=self.traffic["depth"])
        pending = []                 # (step, feed time) in flight, in order
        t_begin = clock()
        try:
            while True:
                step = self.seq
                idx = [self.pool_index(s, step) for s in range(streams)]
                self.attempted += streams
                t0 = clock()
                with span("frame"):
                    pending.append((step, t0))
                    done = server.feed(self.pool[idx], now_ms=step * self.interval)
                t1 = clock()
                self.seq += 1
                self._retired(done, pending, t1)
                if t1 - t_begin >= seconds:
                    break
            with span("frame"):
                done = server.drain()
            t1 = clock()
            self._retired(done, pending, t1)
        finally:
            msp.submit_frames, msp.retire_frames = submit, retire
        return t1 - t_begin

    def _retired(self, steps, pending, t_now) -> None:
        for results in steps:
            step, t_fed = pending.pop(0)
            self.frame_ms.append((t_now - t_fed) * 1e3)
            for s, result in enumerate(results):
                self.keep(result, s, step)

    def carried(self):
        """(A* angle cache entries, instruction memory) of each stream, read
        from the private attributes of the port's processor that hold them:
        the reading its ``carried_state()`` is held against in the port's
        tests. The harness reads ``carried_state()``."""
        msp = self.processor
        if msp._caches[0] is not None:
            device = msp._caches[0].cpu().numpy()
            keys = [int(np.count_nonzero(~np.isnan(row[:-1]))) for row in device]
        else:
            keys = [e.cache_size if hasattr(e, "cache_size") else len(e._angle_cache)
                    for e in msp._exact_engines]
        return list(zip(keys, [a.previous_instructions for a in msp.analysers]))

    def close(self) -> None:
        self.processor.close()
