"""Console CLI of the PyTorch engine: `indextts-tpu-torch "TEXT." -v prompt.wav -o out.wav`.

The reference CLI's flags (indextts/cli.py:7-70) plus the JAX CLI's --fast
(bucketed batch inference, IndexTTS.infer_fast), --fast-latents and
--quant-kv (the int8 KV cache). Weights are random (seed 0) until checkpoint
loading is ported; see ROADMAP.md.
"""

import argparse
import os
import sys

_DESCRIPTION = """IndexTTS on PyTorch (single request).

Decoding runs the engine's defaults, as the reference CLI does: beam search
with num_beams=3, sampled, top-k 30, top-p 0.8, repetition penalty 10.
Without a bpe.model in --model_dir the random-init tokenizer knows only the
26 upper-case ASCII letters, "." and the word separator, so give upper-case
ASCII text."""


def main(argv=None):
    parser = argparse.ArgumentParser(description=_DESCRIPTION, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("text", type=str, nargs="?", default="", help="Text to be synthesized")
    parser.add_argument("-v", "--voice", type=str, default=None, help="Path to the audio prompt file (wav format)")
    parser.add_argument("-o", "--output_path", type=str, default="gen.wav", help="Path to the output wav file")
    parser.add_argument("-c", "--config", type=str, default="checkpoints/config.yaml",
                        help="Path to the config file. Default is 'checkpoints/config.yaml'")
    parser.add_argument("--model_dir", type=str, default="checkpoints", help="Path to the model directory.")
    parser.add_argument("--fp16", action=argparse.BooleanOptionalAction, default=True,
                        help="bf16 compute on the GPU (--no-fp16 for float32)")
    parser.add_argument("-f", "--force", action="store_true", default=False, help="Overwrite the output file if it exists")
    parser.add_argument("-d", "--device", type=str, default="cuda", help="torch device (default cuda)")
    parser.add_argument("--fast", action="store_true", default=False, help="Use bucketed batch inference (infer_fast)")
    parser.add_argument("--fast-latents", action="store_true", default=False,
                        help="Capture vocoder latents during decode (skips the teacher-forced pass when silence "
                             "removal changes nothing; consistent-positions mode)")
    parser.add_argument("--quant-kv", action="store_true", default=False,
                        help="Int8-quantized KV cache for the decode (near-parity outputs)")
    args = parser.parse_args(argv)
    if not args.text.strip():
        print("ERROR: Text is empty.")
        parser.print_help()
        sys.exit(1)
    if args.voice is None or not os.path.exists(args.voice):
        print(f"Audio prompt file {args.voice} does not exist.")
        parser.print_help()
        sys.exit(1)
    if os.path.exists(args.output_path) and not args.force:
        print(f"ERROR: Output file {args.output_path} already exists. Use --force to overwrite.")
        sys.exit(1)

    from indextts_tpu_torch.engine import IndexTTS

    tts = IndexTTS(cfg_path=args.config, model_dir=args.model_dir, is_fp16=args.fp16, device=args.device,
                   allow_random_init=True, quant_kv=args.quant_kv, fast_latents=args.fast_latents)
    infer = tts.infer_fast if args.fast else tts.infer
    infer(audio_prompt=args.voice, text=args.text.strip(), output_path=args.output_path)


if __name__ == "__main__":
    main()
