"""CLI: published torch weight files -> the port's state dicts.

Port of videovanish_tpu/cli/convert.py, writing torch files in place of
orbax. One file at a time, with the published-name fixes applied
(`convert.published_state_dict`) and any LoRA merged in:

    python -m videovanish_tpu_torch.cli.convert \\
        --input diffuEraser/unet_main/diffusion_pytorch_model.safetensors \\
        --model unet --lora pcm_sd15_smallcfg_2step_converted.safetensors \\
        --output ckpt/unet.pt

then `--assemble diffueraser` bundles the pieces into the file
DiffuEraserConfig.checkpoint names, with the null-prompt embedding derived
by the port's CLIP text tower on --device:

    python -m videovanish_tpu_torch.cli.convert --assemble diffueraser \\
        --vae ckpt/vae.pt --unet ckpt/unet.pt --brushnet ckpt/brushnet.pt \\
        --clip ckpt/clip.pt --output checkpoints/diffueraser.pt

--assemble also takes the published files themselves for --vae, --brushnet
and --clip. ProPainter's and SAM2's files load as they ship; converting
them only strips what the port does not hold.
"""
from __future__ import annotations

import argparse
import time

from videovanish_tpu_torch.checkpoint import load_torch_state, save_state
from videovanish_tpu_torch.convert import (
    PUBLISHED_MODELS, merge_lora, parse_lora_state, published_state_dict,
)
from videovanish_tpu_torch.models.diffueraser.text_encoder import (
    derive_null_text_emb,
)


def convert_file(path, model: str, lora_paths=(), lora_scale: float = 1.0):
    """The port's state dict of one published file, each LoRA file folded
    in first (the "unet" tower's entries; the "text_encoder" tower's for
    --model clip). Returns (state, {"read": s, "merge": s})."""
    t0 = time.perf_counter()
    state = load_torch_state(path)
    secs = {"read": time.perf_counter() - t0, "merge": 0.0}
    tower = "text_encoder" if model == "clip" else "unet"
    for lp in lora_paths:
        t0 = time.perf_counter()
        state = merge_lora(state, parse_lora_state(load_torch_state(lp),
                                                   tower),
                           scale=lora_scale)
        secs["merge"] += time.perf_counter() - t0
    return published_state_dict(state, model), secs


def assemble_diffueraser(vae_path, unet_path, brushnet_path, clip_path,
                         device="cuda") -> dict:
    """DiffuEraserConfig.checkpoint's tree {vae, unet, brushnet,
    null_text_emb}: the null-prompt embedding is the CLIP text tower on
    the empty prompt, the conditioning of the reference's guidance-0
    path."""
    return {
        "vae": published_state_dict(load_torch_state(vae_path), "vae"),
        "unet": published_state_dict(load_torch_state(unet_path), "unet"),
        "brushnet": published_state_dict(load_torch_state(brushnet_path),
                                         "brushnet"),
        "null_text_emb": derive_null_text_emb(load_torch_state(clip_path),
                                              device=device),
    }


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def main(argv=None) -> dict:
    """Run the CLI; returns {"tensors", "params", "seconds": {step: s}}."""
    ap = argparse.ArgumentParser(
        description="Convert a published torch/safetensors weight file to "
                    "the port's state dict (a torch file).")
    ap.add_argument("--input", help=".pt/.pth/.bin/.safetensors file")
    ap.add_argument("--model", choices=PUBLISHED_MODELS,
                    help="which model's name fixes to apply")
    ap.add_argument("--output", required=True, help="torch file to write")
    ap.add_argument("--dry_run", action="store_true",
                    help="print the converted tensors, do not save")
    ap.add_argument("--lora", action="append", default=[],
                    help="LoRA file(s) to fold into --input first (peft/"
                         "diffusers or kohya layout; the reference's "
                         "'2-Step' ckpt is a PCM LoRA on the SD1.5 UNet). "
                         "Repeatable; applied in order.")
    ap.add_argument("--lora_scale", type=float, default=1.0,
                    help="multiplier on every merged LoRA delta")
    ap.add_argument("--assemble", choices=["diffueraser"],
                    help="bundle converted pieces instead of converting a "
                         "file")
    ap.add_argument("--vae", help="[assemble] VAE file")
    ap.add_argument("--unet", help="[assemble] UNet file (LoRA merged)")
    ap.add_argument("--brushnet", help="[assemble] BrushNet file")
    ap.add_argument("--clip", help="[assemble] CLIP text encoder file")
    ap.add_argument("--device", default="cuda",
                    help="where --assemble runs the CLIP text tower")
    args = ap.parse_args(argv)

    if args.assemble:
        for f in ("vae", "unet", "brushnet", "clip"):
            if not getattr(args, f):
                ap.error(f"--assemble requires --{f}")
        t0 = time.perf_counter()
        tree = assemble_diffueraser(args.vae, args.unet, args.brushnet,
                                    args.clip, args.device)
        secs = {"assemble": time.perf_counter() - t0}
    else:
        if not args.input or not args.model:
            ap.error("--input and --model are required unless --assemble")
        tree, secs = convert_file(args.input, args.model, args.lora,
                                  args.lora_scale)
    leaves = list(_leaves(tree))
    n_params = sum(int(v.numel()) for _, v in leaves)
    if not args.dry_run:
        t0 = time.perf_counter()
        save_state(args.output, tree)
        secs["write"] = time.perf_counter() - t0
    print(f"[convert] {len(leaves)} tensors, {n_params / 1e6:.1f}M params; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
          + ("" if args.dry_run else f" -> {args.output}"), flush=True)
    if args.dry_run:
        for name, v in leaves:
            print(f"  {name}: {tuple(v.shape)} {str(v.dtype)[6:]}")
    return {"tensors": len(leaves), "params": n_params, "seconds": secs}


if __name__ == "__main__":
    main()
