"""Gradio web demo (reference demo/app.py): video upload triggers
preprocess+load; a JS hook polls the <video> element's currentTime and
drives ``input_video_stream`` at wall-clock rate; a chat box feeds
``input_query_stream``; a generator loop drains engine responses into the
chatbot; a slider adjusts the streaming threshold (demo/app.py:54-57).

gradio is not bundled in every image — the import is lazy with a clear
error. Run:  python -m videollm_online_tpu_torch.serve.app [--device cpu]

Counterpart of ``videollm_online_tpu/serve/app.py`` over the port's
``LiveInferEngine``, which runs on the card unless ``--device cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse
import os

GET_VIDEO_TIME_JS = """
async (video_time, gate) => {
  const videoEl = document.querySelector("#gr_video video");
  return [videoEl ? videoEl.currentTime : video_time, gate];
}
"""


def build_app(engine, frame_fps: float, resolution: int):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; the serving engine "
            "itself is fully usable via serve.cli / serve.engine") from e

    from ..data import video_io

    with gr.Blocks(title="videollm-online-tpu") as app:
        gr.Markdown("## VideoLLM-online (TPU) — streaming video dialogue")
        with gr.Row():
            with gr.Column():
                gr_video = gr.Video(label="video stream", elem_id="gr_video",
                                    autoplay=True)
                gr_threshold = gr.Slider(
                    minimum=0.0, maximum=1.0, step=0.005,
                    value=engine.cfg.frame_token_interval_threshold,
                    label="Streaming threshold",
                    info="P(frame interval) below this fires a response "
                         "(reference demo/inference.py:31)")
                gr_time = gr.Number(value=0, visible=False)
                gr_gate = gr.Number(value=0, visible=False)
            with gr.Column():
                gr_chat = gr.Chatbot(label="dialogue")
                gr_query = gr.Textbox(label="ask anything (streamed)")

        state = {"history": []}

        def on_video(path):
            if path is None:
                return []
            dst = os.path.splitext(path)[0] + f"_{frame_fps:g}fps_{resolution}.mp4"
            if not os.path.exists(dst):
                video_io.ffmpeg_once(path, dst, fps=frame_fps,
                                     resolution=resolution)
            engine.reset()
            engine.load_video(dst)
            state["history"] = []
            return []

        def on_time(video_time, gate):
            if gate:
                engine.set_threshold(float(gate))
            engine.input_video_stream(float(video_time))
            query, response = engine()
            if query:
                state["history"].append((query, None))
            if response:
                state["history"].append((None, response))
            return state["history"]

        def on_query(text):
            engine.input_query_stream(text)
            return ""

        gr_video.change(on_video, [gr_video], [gr_chat])
        gr_time.change(on_time, [gr_time, gr_gate], [gr_chat])
        gr_query.submit(on_query, [gr_query], [gr_query])
        # wall-clock driver: poll the video element twice per frame interval
        app.load(None, [gr_time, gr_gate], [gr_time, gr_gate],
                 js=GET_VIDEO_TIME_JS, every=0.5 / frame_fps)
    return app


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default="")
    p.add_argument("--model_size", default="tiny")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="",
                   help="'cpu' for the CPU; the card otherwise")
    args = p.parse_args(argv)
    from .cli import build_engine

    class _A:  # reuse the CLI builder's arg surface
        checkpoint = args.checkpoint
        vision_checkpoint = ""
        tokenizer = ""
        model_size = args.model_size
        dtype = "bfloat16"
        with_vision = True
        kv_capacity = 16384
        seed = 0
        device = args.device

    engine, cfg = build_engine(_A)
    app = build_app(engine, cfg.frame_fps, cfg.frame_resolution)
    app.queue().launch(server_port=args.port)


if __name__ == "__main__":
    main()
