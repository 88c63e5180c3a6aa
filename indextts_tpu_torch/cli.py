"""Console CLI of the PyTorch engine: `indextts-tpu-torch "TEXT." -v prompt.wav -o out.wav`.

The reference CLI's flags (indextts/cli.py:7-70) plus the JAX CLI's --fast
(bucketed batch inference, IndexTTS.infer_fast), --fast-latents,
--quant-kv (the int8 KV cache), --batch-file (a TSV of jobs run as one
IndexTTS.infer_batch call) and --tp (tensor parallelism over the ranks of a
torchrun launch: every rank runs main, rank 0 writes the output). The weights come from --model_dir: the
reference's gpt.pth, bigvgan_generator.pth and bpe.model, or the .npz caches
of the converted checkpoints; a missing one raises FileNotFoundError, as the
JAX CLI does.
"""

import argparse
import os
import sys

_DESCRIPTION = """IndexTTS on PyTorch (single request).

Decoding runs the engine's defaults, as the reference CLI does: beam search
with num_beams=3, sampled, top-k 30, top-p 0.8, repetition penalty 10.
--model_dir holds gpt.pth, bigvgan_generator.pth and bpe.model (a .pth is
converted once and cached beside it as .pth.npz)."""


def main(argv=None):
    parser = argparse.ArgumentParser(description=_DESCRIPTION, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("text", type=str, nargs="?", default="", help="Text to be synthesized")
    parser.add_argument("-v", "--voice", type=str, default=None, help="Path to the audio prompt file (wav format)")
    parser.add_argument("-o", "--output_path", type=str, default=None,
                        help="Path to the output wav file (default gen.wav); with --batch-file the output "
                             "DIRECTORY (default gen_batch/)")
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
    parser.add_argument("--tp", type=int, default=None,
                        help="Tensor-parallel degree over the ranks of a torchrun launch (default 2 when the "
                             "world is even; one process ignores it): torchrun --nproc-per-node N -m "
                             "indextts_tpu_torch.cli ... --tp T; rank 0 writes the output")
    parser.add_argument("--batch-file", type=str, default=None,
                        help="TSV of synthesis jobs, one per line: 'text' (uses -v voice) or 'voice_path<TAB>text'. "
                             "All jobs run as ONE batch (engine.infer_batch: decode batches across requests)")
    args = parser.parse_args(argv)
    if args.batch_file:
        if not os.path.exists(args.batch_file):
            print(f"Batch file {args.batch_file} does not exist.")
            sys.exit(1)
    else:
        if not args.text.strip():
            print("ERROR: Text is empty.")
            parser.print_help()
            sys.exit(1)
        if args.voice is None or not os.path.exists(args.voice):
            print(f"Audio prompt file {args.voice} does not exist.")
            parser.print_help()
            sys.exit(1)
    if not os.path.exists(args.config):
        print(f"Config file {args.config} does not exist.")
        parser.print_help()
        sys.exit(1)
    output_path = args.output_path or ("gen_batch" if args.batch_file else "gen.wav")
    if not args.batch_file and os.path.exists(output_path) and not args.force:
        print(f"ERROR: Output file {output_path} already exists. Use --force to overwrite.")
        sys.exit(1)
    items = _batch_items(args) if args.batch_file else None

    from indextts_tpu_torch.engine import IndexTTS

    tts = IndexTTS(cfg_path=args.config, model_dir=args.model_dir, is_fp16=args.fp16, device=args.device,
                   tp=args.tp, quant_kv=args.quant_kv, fast_latents=args.fast_latents)
    if items is not None:
        os.makedirs(output_path, exist_ok=True)
        paths = [os.path.join(output_path, f"{i:03d}.wav") for i in range(len(items))]
        for p in paths:
            if os.path.exists(p) and not args.force:
                print(f"ERROR: Output file {p} already exists. Use --force to overwrite.")
                sys.exit(1)
        tts.infer_batch(items, output_paths=paths)
        return
    infer = tts.infer_fast if args.fast else tts.infer
    infer(audio_prompt=args.voice, text=args.text.strip(), output_path=output_path)


def _batch_items(args):
    """The (voice, text) jobs of --batch-file, checked before the models load."""
    items = []
    with open(args.batch_file, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\r\n")  # a CRLF file's \r must not stick to paths or text
            if not line.strip():
                continue
            # the first tab separates voice from text; later tabs stay in the text
            voice, sep, text = line.partition("\t")
            if not sep:
                voice, text = "", line
            voice = voice or args.voice
            if not voice or not os.path.exists(voice):
                print(f"ERROR: {args.batch_file}:{ln}: no voice file ({voice!r}): give 'voice<TAB>text' or -v.")
                sys.exit(1)
            if not text.strip():
                print(f"ERROR: {args.batch_file}:{ln}: empty text.")
                sys.exit(1)
            items.append((voice, text.strip()))
    if not items:
        print(f"ERROR: {args.batch_file} has no jobs.")
        sys.exit(1)
    return items


if __name__ == "__main__":
    main()
