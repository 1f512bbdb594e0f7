"""One camera, closed loop: the port's ``FrameProcessor.submit_frame`` then
``retire_frame`` (what ``__call__`` runs), the next frame once the answer
is back. ``frame_ms`` holds each frame's host time from the frame handed
to ``submit_frame`` to ``retire_frame`` returning."""

import time

from benchmark.harness.serve import Loop as _Loop
from benchmark.harness.trace import span


class Loop(_Loop):
    def build(self, cfg, device):
        from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

        if self.traffic["streams"] != 1:
            raise ValueError("the synchronous loop serves one stream")
        return FrameProcessor(cfg, segmenter=self.segmenter, device=device)

    def serve(self, seconds: float) -> float:
        fp, clock = self.processor, time.perf_counter
        t_begin = clock()
        while True:
            seq = self.seq
            self.attempted += 1
            with span("frame"):
                t0 = clock()
                with span("submit"):
                    handle = fp.submit_frame(self.pool[self.pool_index(0, seq)])
                t1 = clock()
                with span("retire"):
                    result = fp.retire_frame(handle, now_ms=seq * self.interval)
                t2 = clock()
            self.seq += 1
            self.spans["submit"].append(t1 - t0)
            self.spans["retire"].append(t2 - t1)
            self.frame_ms.append((t2 - t0) * 1e3)
            self.keep(result, 0, seq)
            if t2 - t_begin >= seconds:
                return t2 - t_begin

    def carried(self):
        """(A* angle cache entries, instruction memory) of each stream, read
        from the private attributes of the port's processor that hold them:
        the reading its ``carried_state()`` is held against in the port's
        tests. The harness reads ``carried_state()``."""
        fp = self.processor
        if fp._astar_cache is not None:
            import numpy as np

            keys = int(np.count_nonzero(~np.isnan(fp._astar_cache[:-1].cpu().numpy())))
        else:
            e = fp._exact
            keys = e.cache_size if hasattr(e, "cache_size") else len(e._angle_cache)
        return [(keys, fp.analyser.previous_instructions)]
