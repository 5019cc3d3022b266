"""The vision tower of the encode worker: a ViT with HF CLIP-vision semantics
in PyTorch (the counterpart of dynamo_tpu/multimodal/vit.py).

``VisionTower`` is an ``nn.Module`` over the reference's params tree: the
conv patch embedding as one unfold and one matmul, the class token and the
learned position embedding, pre-LN, blocks of bidirectional attention (in
f32, the reference's einsum form) and quick-GELU MLPs, post-LN, the class
token dropped. ``project`` is the LLaVA-style two-layer projector (exact erf
GELU) from the vision hidden to the LLM's. The reference computes the tower
in XLA, not in a Pallas kernel, so its products stay ``torch.matmul`` here.
Matmuls run in true f32 (TF32 is never turned on).

``params_from_torch`` maps a ``transformers.CLIPVisionModel`` (or LLaVA)
state dict onto the tree, as the reference's does; ``params_from_numpy``
carries a tree of arrays (the JAX ``init_vit_params``) across; ``VitEncoder``
serves ``encode`` on an explicit device, with an explicit generator for its
seeded init. Images decode through multimodal/image.py (PNG, JPEG and GIF).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynamo_tpu_torch.multimodal.image import CLIP_MEAN, CLIP_STD, preprocess_image

__all__ = [
    "CLIP_MEAN", "CLIP_STD", "VisionTower", "VitEncoder", "VitSpec",
    "init_projector_params", "init_vit_params", "params_from_numpy",
    "params_from_torch", "params_to", "patchify", "project",
]

log = logging.getLogger("dynamo_tpu_torch.mm.vit")


@dataclass(frozen=True)
class VitSpec:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    # LLaVA-style projector (0 = raw vision hidden out)
    projector_hidden: int = 0
    llm_hidden: int = 0

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens_per_image(self) -> int:
        return self.patches_per_side ** 2

    @classmethod
    def tiny(cls) -> "VitSpec":
        return cls(hidden_size=32, intermediate_size=64, num_layers=2,
                   num_heads=4, image_size=28, patch_size=14)

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "VitSpec":
        """From a CLIPVisionConfig dict (``vision_config`` of a llava or
        clip checkpoint's config.json)."""
        return cls(
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            image_size=cfg["image_size"],
            patch_size=cfg["patch_size"],
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        )


# ------------------------------------------------------------------ params


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
            * 0.02).to(device)


def init_vit_params(spec: VitSpec, gen: torch.Generator,
                    device: torch.device | str = "cpu") -> dict[str, Any]:
    """The reference's tree at its init scales (normal * 0.02, LayerNorms 1
    and 0, biases 0), drawn from ``gen``."""
    d, i, P = spec.hidden_size, spec.intermediate_size, spec.patch_size

    def ln():
        return {"w": torch.ones(d, device=device), "b": torch.zeros(d, device=device)}

    params: dict[str, Any] = {
        "class_embedding": _normal(gen, (d,), device),
        "patch_embedding": _normal(gen, (3 * P * P, d), device),  # unfold layout
        "position_embedding": _normal(gen, (spec.tokens_per_image + 1, d), device),
        "pre_ln": ln(), "post_ln": ln(), "layers": [],
    }
    for _ in range(spec.num_layers):
        lp: dict[str, Any] = {"ln1": ln(), "ln2": ln()}
        for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"), ("wo", "bo")):
            lp[w] = _normal(gen, (d, d), device)
            lp[b] = torch.zeros(d, device=device)
        lp["fc1"], lp["b1"] = _normal(gen, (d, i), device), torch.zeros(i, device=device)
        lp["fc2"], lp["b2"] = _normal(gen, (i, d), device), torch.zeros(d, device=device)
        params["layers"].append(lp)
    if spec.projector_hidden and spec.llm_hidden:
        params["projector"] = init_projector_params(spec, gen, device)
    return params


def init_projector_params(spec: VitSpec, gen: torch.Generator,
                          device: torch.device | str = "cpu") -> dict[str, Any]:
    return {
        "w1": _normal(gen, (spec.hidden_size, spec.projector_hidden), device),
        "b1": torch.zeros(spec.projector_hidden, device=device),
        "w2": _normal(gen, (spec.projector_hidden, spec.llm_hidden), device),
        "b2": torch.zeros(spec.llm_hidden, device=device),
    }


def params_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    """A tree of arrays (dicts and lists of anything ``np.asarray`` takes,
    such as the JAX ``init_vit_params``) -> the same tree of f32 tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def params_from_torch(spec: VitSpec, state_dict,
                      device: torch.device | str = "cpu") -> dict[str, Any]:
    """Map a ``transformers.CLIPVisionModel`` state dict onto the tree, as the
    reference's ``params_from_torch``: linear weights transpose ([out, in]
    -> [in, out]), the conv patch embedding flattens to the ``patchify``
    layout. A full LLaVA checkpoint works too (the ``vision_tower.`` prefix
    and its ``multi_modal_projector``); a projector the spec asks for but the
    checkpoint lacks is random-initialized (and logged)."""

    def t(name):
        return torch.as_tensor(state_dict[name]).detach().to(
            device="cpu", dtype=torch.float32).to(device)

    pre = "vision_model."
    if not any(k.startswith(pre) for k in state_dict):
        pre = "vision_tower.vision_model."  # LLaVA layout
    conv = t(pre + "embeddings.patch_embedding.weight")  # [d, 3, P, P]
    params: dict[str, Any] = {
        "class_embedding": t(pre + "embeddings.class_embedding"),
        "patch_embedding": conv.reshape(conv.shape[0], -1).T.contiguous(),
        "position_embedding": t(pre + "embeddings.position_embedding.weight"),
        # (sic: HF's CLIP spells it "pre_layrnorm")
        "pre_ln": {"w": t(pre + "pre_layrnorm.weight"), "b": t(pre + "pre_layrnorm.bias")},
        "post_ln": {"w": t(pre + "post_layernorm.weight"),
                    "b": t(pre + "post_layernorm.bias")},
        "layers": [],
    }
    for li in range(spec.num_layers):
        lp = pre + f"encoder.layers.{li}."
        layer = {
            "ln1": {"w": t(lp + "layer_norm1.weight"), "b": t(lp + "layer_norm1.bias")},
            "ln2": {"w": t(lp + "layer_norm2.weight"), "b": t(lp + "layer_norm2.bias")},
        }
        for w, b, name in (("wq", "bq", "q_proj"), ("wk", "bk", "k_proj"),
                           ("wv", "bv", "v_proj"), ("wo", "bo", "out_proj")):
            layer[w] = t(lp + f"self_attn.{name}.weight").T.contiguous()
            layer[b] = t(lp + f"self_attn.{name}.bias")
        for w, b, name in (("fc1", "b1", "fc1"), ("fc2", "b2", "fc2")):
            layer[w] = t(lp + f"mlp.{name}.weight").T.contiguous()
            layer[b] = t(lp + f"mlp.{name}.bias")
        params["layers"].append(layer)
    mm = "multi_modal_projector."
    if mm + "linear_1.weight" in state_dict:
        # a checkpoint's projector is always mapped, even when the spec did
        # not ask for one; VitEncoder takes its output width from its shapes
        params["projector"] = {
            "w1": t(mm + "linear_1.weight").T.contiguous(), "b1": t(mm + "linear_1.bias"),
            "w2": t(mm + "linear_2.weight").T.contiguous(), "b2": t(mm + "linear_2.bias"),
        }
    elif spec.projector_hidden and spec.llm_hidden:
        log.warning("vit: spec wants a %d->%d projector but the checkpoint has none; "
                    "random-initializing it", spec.hidden_size, spec.llm_hidden)
        params["projector"] = init_projector_params(
            spec, torch.Generator().manual_seed(0), device)
    # fail fast on a geometry mismatch (a 224 px checkpoint under a 336 px
    # spec): the position rows define the token grid
    n_pos = params["position_embedding"].shape[0]
    if n_pos != spec.tokens_per_image + 1:
        raise ValueError(
            f"checkpoint geometry mismatch: {n_pos} position rows vs "
            f"spec {spec.tokens_per_image + 1} "
            f"(image {spec.image_size}px / patch {spec.patch_size})"
        )
    return params


# ----------------------------------------------------------------- forward


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, 3, H, W] -> [B, n_patches, 3*patch*patch]: the row-major patch
    grid, channel-major within a patch (the conv weight's flattening in
    ``params_from_torch``), so the patch embedding is one matmul."""
    return F.unfold(pixels, kernel_size=patch, stride=patch).transpose(1, 2)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    # HF CLIP's hidden_act: x * sigmoid(1.702 x)
    return x * torch.sigmoid(1.702 * x)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _LayerNorm(nn.Module):
    def __init__(self, p: dict, eps: float):
        super().__init__()
        self.weight, self.bias, self.eps = _frozen(p["w"]), _frozen(p["b"]), eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps)


class _Block(nn.Module):
    """Pre-LN encoder block: bidirectional attention, then the MLP."""

    def __init__(self, spec: VitSpec, lp: dict):
        super().__init__()
        self.heads = spec.num_heads
        self.ln1 = _LayerNorm(lp["ln1"], spec.layer_norm_eps)
        self.ln2 = _LayerNorm(lp["ln2"], spec.layer_norm_eps)
        for name in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
                     "fc1", "b1", "fc2", "b2"):
            setattr(self, name, _frozen(lp[name]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        H = self.heads
        hd = d // H
        h = self.ln1(x)
        q = (h @ self.wq + self.bq).reshape(B, T, H, hd)
        k = (h @ self.wk + self.bk).reshape(B, T, H, hd)
        v = (h @ self.wv + self.bv).reshape(B, T, H, hd)
        logits = torch.einsum("bthd,bshd->bhts", q, k) * (1.0 / float(hd) ** 0.5)
        probs = torch.softmax(logits, dim=-1)  # bidirectional: no mask
        attn = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, d)
        x = x + (attn @ self.wo + self.bo)
        h = self.ln2(x)
        return x + (_quick_gelu(h @ self.fc1 + self.b1) @ self.fc2 + self.b2)


class VisionTower(nn.Module):
    """[B, 3, S, S] normalized pixels -> [B, tokens_per_image, d] patch
    embeddings (post-LN, class token dropped: the injection rows before
    ``project``). The module's parameters are the tree's tensors."""

    def __init__(self, spec: VitSpec, params: dict[str, Any]):
        super().__init__()
        self.spec = spec
        self.class_embedding = _frozen(params["class_embedding"])
        self.patch_embedding = _frozen(params["patch_embedding"])
        self.position_embedding = _frozen(params["position_embedding"])
        self.pre_ln = _LayerNorm(params["pre_ln"], spec.layer_norm_eps)
        self.post_ln = _LayerNorm(params["post_ln"], spec.layer_norm_eps)
        self.layers = nn.ModuleList(_Block(spec, lp) for lp in params["layers"])

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B = pixels.shape[0]
        d = self.spec.hidden_size
        x = patchify(pixels.float(), self.spec.patch_size) @ self.patch_embedding
        cls = self.class_embedding.expand(B, 1, d)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        x = self.pre_ln(x)
        for block in self.layers:
            x = block(x)
        return self.post_ln(x)[:, 1:, :]


def project(p: dict[str, Any], rows: torch.Tensor) -> torch.Tensor:
    """LLaVA-style two-layer GELU MLP: vision hidden -> LLM hidden. ``p`` is
    the projector subtree (w1/b1/w2/b2)."""
    h = F.gelu(rows @ p["w1"] + p["b1"], approximate="none")
    return h @ p["w2"] + p["b2"]


class VitEncoder:
    """The vision tower behind the same ``encode`` interface as
    MockVisionEncoder: image bytes -> stacked embedding rows. With a
    projector the rows are already LLM-hidden wide. ``device`` None is the
    GPU (no GPU raises); without ``params`` the random init draws from
    ``generator``, which is then required."""

    def __init__(self, spec: VitSpec, params: dict[str, Any] | None = None, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        from dynamo_tpu_torch.models.llama import resolve_device

        self.spec = spec
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                raise ValueError("VitEncoder: a random init needs a generator")
            params = init_vit_params(spec, generator, self.device)
        else:
            params = params_to(params, self.device)
        self.params = params
        self.tower = VisionTower(spec, params).eval()
        self.tokens_per_image = spec.tokens_per_image
        # the output width comes from the projector's actual shapes (a LLaVA
        # checkpoint carries one even when vision == LLM hidden)
        self.hidden_size = (int(params["projector"]["w2"].shape[1])
                            if "projector" in params else spec.hidden_size)

    @classmethod
    def from_torch(cls, spec: VitSpec, state_dict, *,
                   device: torch.device | str | None = None) -> "VitEncoder":
        return cls(spec, params_from_torch(spec, state_dict), device=device)

    def pixels(self, images: list[bytes]) -> torch.Tensor:
        """Decoded, CLIP-preprocessed images [n, 3, S, S] f32 on the device."""
        arr = np.stack([preprocess_image(b, self.spec.image_size) for b in images])
        return torch.from_numpy(arr).to(self.device)

    @torch.inference_mode()
    def forward_pixels(self, pixels: torch.Tensor) -> torch.Tensor:
        """[n, 3, S, S] -> rows [n * tokens_per_image, hidden] f32 on the
        device (the tower, then the projector when there is one)."""
        rows = self.tower(pixels)
        if "projector" in self.params:
            rows = project(self.params["projector"], rows)
        return rows.reshape(-1, rows.shape[-1])

    def encode(self, images: list[bytes]) -> np.ndarray:
        if not images:
            return np.zeros((0, self.hidden_size), np.float32)
        return self.forward_pixels(self.pixels(images)).float().cpu().numpy()


def params_to(tree: Any, device: torch.device | str) -> Any:
    """The same tree of tensors as f32 on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to(v, device) for v in tree]
    return tree.to(device=device, dtype=torch.float32)
