"""CLIP ViT vision tower + llava multimodal projector (counterpart of
tpulamm.models.clip).

Loads an mmproj GGUF (keys `clip.vision.*`, tensors `v.*` / `mm.*`,
clip.cpp:73-122 of the reference) and encodes images into projected
embeddings that Engine.eval_embeds splices into the language model's
stream (the llama_batch.embd path).

Graph parity with clip.cpp:clip_image_build_graph (:506-700): patch conv
(a reshape and one (N, p*p*3) x (p*p*3, d) product) -> prepend the class
embedding -> + position embedding -> pre_ln -> n_layer pre-LN blocks
(biased MHA, quick-gelu or gelu MLP) -> drop the class token -> projector
(mlp: mm.0 -> gelu -> mm.2, or mlp_norm). No post_ln in the llava path.

Its products are plain dense products, which the JAX package also
computes outside any Pallas kernel, so they stay torch.matmul / einsum in
the tower's compute dtype (bf16 by default; f32 scores and softmax, as the
JAX encoder has them). Images are numpy arrays: .npy, binary .ppm, or
through PIL where it is installed (imported only then).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int
    n_heads: int
    n_layers: int
    n_ff: int
    image_size: int
    patch_size: int
    eps: float = 1e-5
    use_gelu: bool = False           # false -> quick_gelu (openai CLIP)
    proj_type: str = "mlp"           # mlp | mlp_norm
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)
    # llava-1.6 (anyres): flattened [w0,h0,w1,h1,...] candidate canvas
    # sizes; empty = llava-1.5 single-image path
    image_grid_pinpoints: tuple = ()
    mm_patch_merge_type: str = "flat"   # flat | spatial_unpad

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_heads


def load_clip(path: str, compute_dtype=torch.bfloat16, device=None):
    """Load an mmproj GGUF -> (cfg, params) on `device` (None: CUDA, which
    raises without a GPU). All tensors dense (the vision tower is ~300M
    params; quantized mmproj files are rare and small). compute_dtype: a
    torch dtype or its name."""
    from tpulamm_torch.gguf.reader import GGUFReader
    from tpulamm_torch.runtime.engine import resolve_device

    dev = resolve_device(device)
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    rd = GGUFReader(path)
    md = rd.metadata
    if not md.get("clip.has_vision_encoder", True):
        raise ValueError(f"{path}: no vision encoder")

    def g(key, default=None):
        v = md.get(key, default)
        if v is None:
            raise KeyError(f"{path}: missing metadata {key}")
        return v

    cfg = ClipVisionConfig(
        hidden_size=int(g("clip.vision.embedding_length")),
        n_heads=int(g("clip.vision.attention.head_count")),
        n_layers=int(g("clip.vision.block_count")),
        n_ff=int(g("clip.vision.feed_forward_length")),
        image_size=int(g("clip.vision.image_size")),
        patch_size=int(g("clip.vision.patch_size")),
        eps=float(g("clip.vision.attention.layer_norm_epsilon", 1e-5)),
        use_gelu=bool(md.get("clip.use_gelu", False)),
        proj_type=str(md.get("clip.projector_type", "mlp")),
        image_mean=tuple(md.get("clip.vision.image_mean",
                                ClipVisionConfig.image_mean)),
        image_std=tuple(md.get("clip.vision.image_std",
                               ClipVisionConfig.image_std)),
        # the reader gives an int array: `array or ()` would raise, as it
        # does in the JAX load_clip (ROADMAP section 3)
        image_grid_pinpoints=tuple(
            int(x) for x in md.get("clip.vision.image_grid_pinpoints", ())),
        mm_patch_merge_type=str(
            md.get("clip.vision.mm_patch_merge_type", "flat")),
    )

    def dense(arr, dtype):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            device=dev, dtype=dtype)

    def t(name, dtype=compute_dtype):
        if name not in rd.tensors:
            raise KeyError(f"{path}: missing tensor {name}")
        return dense(rd.tensors[name].to_f32(), dtype)

    def opt(name, dtype=compute_dtype):
        return t(name, dtype) if name in rd.tensors else None

    p = cfg.patch_size
    # conv weight (hidden, 3, p, p) -> (p*p*3, hidden) matmul plane, patch
    # pixels flattened in (ph, pw, c) order to match
    conv = np.asarray(rd.tensors["v.patch_embd.weight"].to_f32(),
                      np.float32).reshape(cfg.hidden_size, 3, p, p)
    params = {
        "patch_w": dense(conv.transpose(2, 3, 1, 0).reshape(
            p * p * 3, cfg.hidden_size), compute_dtype),
        "class_embd": t("v.class_embd"),
        "pos_embd": t("v.position_embd.weight"),
        "pre_ln_w": t("v.pre_ln.weight", torch.float32),
        "pre_ln_b": t("v.pre_ln.bias", torch.float32),
        "layers": [],
        "mm": {},
    }
    for i in range(cfg.n_layers):
        pre = f"v.blk.{i}."
        params["layers"].append({
            k: t(pre + n) for k, n in (
                ("wq", "attn_q.weight"), ("bq", "attn_q.bias"),
                ("wk", "attn_k.weight"), ("bk", "attn_k.bias"),
                ("wv", "attn_v.weight"), ("bv", "attn_v.bias"),
                ("wo", "attn_out.weight"), ("bo", "attn_out.bias"),
                ("w_up", "ffn_up.weight"), ("b_up", "ffn_up.bias"),
                ("w_down", "ffn_down.weight"), ("b_down", "ffn_down.bias"))
        } | {
            k: t(pre + n, torch.float32) for k, n in (
                ("ln1_w", "ln1.weight"), ("ln1_b", "ln1.bias"),
                ("ln2_w", "ln2.weight"), ("ln2_b", "ln2.bias"))
        })
    for i in (0, 1, 2, 3, 4):
        w, b = opt(f"mm.{i}.weight"), opt(f"mm.{i}.bias")
        if w is not None:
            params["mm"][i] = (w, b)
    # llava-1.6 row separator embedding (model.image_newline in HF,
    # written by the reference's surgery script)
    params["image_newline"] = opt("model.image_newline", torch.float32)
    rd.close()
    return cfg, params


def _ln(x, w, b, eps):
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(v + eps) * w + b


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")   # ggml_gelu


def _act(x, use_gelu):
    if use_gelu:
        return _gelu(x)
    return x * torch.sigmoid(1.702 * x)                      # ggml_gelu_quick


def encode_image(cfg: ClipVisionConfig, params, pixels) -> torch.Tensor:
    """pixels: (B, H, W, 3) normalized f32 (numpy or a tensor) -> (B,
    n_patches, proj_dim) f32 on the tower's device
    (clip.cpp:clip_image_batch_encode)."""
    cd = params["patch_w"].dtype
    dev = params["patch_w"].device
    pixels = torch.as_tensor(np.asarray(pixels, np.float32)
                             if isinstance(pixels, np.ndarray) else pixels)
    pixels = pixels.to(device=dev, dtype=torch.float32)
    B = pixels.shape[0]
    p, d = cfg.patch_size, cfg.hidden_size
    g = cfg.image_size // p
    with torch.no_grad():
        # patchify: (B, gh, p, gw, p, 3) -> (B, N, p*p*3), (ph, pw, c) order
        x = pixels.reshape(B, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, g * g, p * p * 3).to(cd)
        h = x @ params["patch_w"]
        cls = params["class_embd"].expand(B, 1, d)
        h = torch.cat([cls, h], dim=1)                       # (B, N+1, d)
        h = (h.to(torch.float32)
             + params["pos_embd"][: h.shape[1]].to(torch.float32))
        h = _ln(h, params["pre_ln_w"], params["pre_ln_b"], cfg.eps).to(cd)

        nh, hd = cfg.n_heads, cfg.head_dim
        scale = torch.tensor(1.0 / float(np.sqrt(hd)), dtype=cd, device=dev)
        for lyr in params["layers"]:
            cur = _ln(h, lyr["ln1_w"], lyr["ln1_b"], cfg.eps).to(cd)
            q = (cur @ lyr["wq"].T + lyr["bq"]) * scale
            k = cur @ lyr["wk"].T + lyr["bk"]
            v = cur @ lyr["wv"].T + lyr["bv"]
            T = cur.shape[1]
            q = q.reshape(B, T, nh, hd).transpose(1, 2)
            k = k.reshape(B, T, nh, hd).transpose(1, 2)
            v = v.reshape(B, T, nh, hd).transpose(1, 2)
            # f32 scores and softmax (preferred_element_type=f32)
            att = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                               k.to(torch.float32))
            att = torch.softmax(att, dim=-1).to(cd)
            out = torch.einsum("bhqk,bhkd->bhqd", att, v)
            out = out.transpose(1, 2).reshape(B, T, d)
            h = h + (out @ lyr["wo"].T + lyr["bo"])
            cur = _ln(h, lyr["ln2_w"], lyr["ln2_b"], cfg.eps).to(cd)
            cur = _act(cur @ lyr["w_up"].T + lyr["b_up"], cfg.use_gelu)
            h = h + (cur @ lyr["w_down"].T + lyr["b_down"])

        h = h[:, 1:]                                         # drop class token
        mm = params["mm"]
        if cfg.proj_type == "mlp":
            h = h @ mm[0][0].T + mm[0][1]
            h = _gelu(h.to(torch.float32)).to(cd)
            h = h @ mm[2][0].T + mm[2][1]
        elif cfg.proj_type == "mlp_norm":
            h = h @ mm[0][0].T + mm[0][1]
            h = _ln(h, mm[1][0].to(torch.float32),
                    mm[1][1].to(torch.float32), cfg.eps).to(cd)
            h = _gelu(h.to(torch.float32)).to(cd)
            h = h @ mm[3][0].T + mm[3][1]
            h = _ln(h, mm[4][0].to(torch.float32),
                    mm[4][1].to(torch.float32), cfg.eps).to(cd)
        else:
            raise NotImplementedError(f"projector type {cfg.proj_type}")
        return h.to(torch.float32)


def preprocess_image(img: np.ndarray, cfg: ClipVisionConfig,
                     pad2square: bool = True) -> np.ndarray:
    """uint8 (H, W, 3) -> normalized f32 (S, S, 3).

    llava-1.5 recipe (clip.cpp:clip_image_preprocess:1422-1464): pad to
    square with the background mean color, bilinear-resize to image_size,
    then (x/255 - mean) / std per channel.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    h, w = img.shape[:2]
    if pad2square and h != w:
        side = max(h, w)
        bg = np.asarray([round(m * 255) for m in cfg.image_mean], np.uint8)
        sq = np.full((side, side, 3), bg, np.uint8)
        sq[(side - h) // 2:(side - h) // 2 + h,
           (side - w) // 2:(side - w) // 2 + w] = img
        img = sq
    img = _bilinear_resize(img.astype(np.float32),
                           cfg.image_size, cfg.image_size)
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    return ((img / 255.0) - mean) / std


def _bilinear_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Vectorized bilinear resample, same pixel-center convention as
    clip.cpp:bilinear_resize:1287-1320 (x_ratio=(w-1)/ow, no half-pixel)."""
    h, w = img.shape[:2]
    if (h, w) == (oh, ow):
        return img
    ys = np.arange(oh, dtype=np.float32) * ((h - 1) / oh)
    xs = np.arange(ow, dtype=np.float32) * ((w - 1) / ow)
    y0 = np.clip(ys.astype(np.int64), 0, h - 2)
    x0 = np.clip(xs.astype(np.int64), 0, w - 2)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x0 + 1]
    c = img[y0 + 1][:, x0]
    d = img[y0 + 1][:, x0 + 1]
    return (a * (1 - wx) * (1 - wy) + b * wx * (1 - wy)
            + c * (1 - wx) * wy + d * wx * wy)


def load_image(path: str) -> np.ndarray:
    """Read an image file to uint8 (H, W, 3). Uses PIL when available,
    falls back to .npy / raw .ppm."""
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        pass
    if path.endswith(".ppm"):
        with open(path, "rb") as f:
            assert f.readline().strip() == b"P6"
            line = f.readline()
            while line.startswith(b"#"):
                line = f.readline()
            w, h = map(int, line.split())
            f.readline()
            return np.frombuffer(f.read(w * h * 3),
                                 np.uint8).reshape(h, w, 3)
    raise RuntimeError(f"cannot load {path}: PIL unavailable; use .npy/.ppm")


# ---------------------------------------------------------------------------
# llava-1.6 "anyres" image grids (clip.cpp:1202 select_best_resolution,
# llava.cpp:140-250 clip_llava_handle_patches)
# ---------------------------------------------------------------------------

def _normalize(img_f32: np.ndarray, cfg: ClipVisionConfig) -> np.ndarray:
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    return ((img_f32 / 255.0) - mean) / std


def select_best_resolution(orig_hw: tuple[int, int],
                           pinpoints) -> tuple[int, int]:
    """Pick the candidate canvas maximizing effective resolution with
    minimal waste (clip.cpp:select_best_resolution:1202). pinpoints is the
    GGUF flat list [w0, h0, w1, h1, ...]; returns (h, w)."""
    oh, ow = orig_hw
    best, best_eff, min_waste = None, -1, None
    pts = list(pinpoints)
    for i in range(0, len(pts) - 1, 2):
        w, h = int(pts[i]), int(pts[i + 1])
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < min_waste):
            best, best_eff, min_waste = (h, w), eff, waste
    assert best is not None, "empty image_grid_pinpoints"
    return best


def _resize_and_pad(img: np.ndarray, target_hw: tuple[int, int],
                    cfg: ClipVisionConfig) -> np.ndarray:
    """Aspect-preserving resize onto a mean-color (th, tw) canvas,
    centered (clip.cpp:resize_and_pad_image)."""
    th, tw = target_hw
    h, w = img.shape[:2]
    scale = min(tw / w, th / h)
    # clip.cpp truncates (no rounding) when scaling
    nh, nw = min(th, int(h * scale)), min(tw, int(w * scale))
    resized = _bilinear_resize(img.astype(np.float32), nh, nw)
    bg = np.asarray([m * 255.0 for m in cfg.image_mean], np.float32)
    canvas = np.broadcast_to(bg, (th, tw, 3)).copy()
    y0, x0 = (th - nh) // 2, (tw - nw) // 2
    canvas[y0:y0 + nh, x0:x0 + nw] = resized
    return canvas


def preprocess_anyres(img: np.ndarray, cfg: ClipVisionConfig):
    """uint8 (H, W, 3) -> (tiles (1+gy*gx, S, S, 3) normalized f32,
    (gy, gx), orig (h, w)).

    tiles[0] is the squash-resized base image (llava-1.6 base features);
    tiles[1:] are the S x S cuts of the best-resolution padded canvas, in
    row-major order.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    S = cfg.image_size
    oh, ow = img.shape[:2]
    th, tw = select_best_resolution((oh, ow), cfg.image_grid_pinpoints)
    canvas = _resize_and_pad(img, (th, tw), cfg)
    gy, gx = th // S, tw // S
    tiles = [_bilinear_resize(img.astype(np.float32), S, S)]  # base (squash)
    for y in range(gy):
        for x in range(gx):
            tiles.append(canvas[y * S:(y + 1) * S, x * S:(x + 1) * S])
    return (_normalize(np.stack(tiles), cfg), (gy, gx), (oh, ow))


def _unpad_spatial(feat: np.ndarray, orig_hw: tuple[int, int]) -> np.ndarray:
    """Crop the dimension that was padded during resize_and_pad
    (llava.cpp:unpad_image). feat: (H, W, d) spatial feature map."""
    H, W, _ = feat.shape
    oh, ow = orig_hw
    if ow / oh > W / H:          # image wider than canvas aspect: rows padded
        nh = max(1, int(oh * (W / ow)))    # llava.cpp truncates
        pad = (H - nh) // 2
        return feat[pad:H - pad]
    nw = max(1, int(ow * (H / oh)))    # llava.cpp truncates
    pad = (W - nw) // 2
    return feat[:, pad:W - pad]


def encode_image_anyres(cfg: ClipVisionConfig, params,
                        img: np.ndarray) -> np.ndarray:
    """llava-1.6 pipeline: grid-tile the image, encode every tile in one
    batch, merge per mm_patch_merge_type:

    - spatial_unpad: tile features rearranged to a (gy*ph, gx*pw) spatial
      map, unpadded back to the image aspect, an image_newline embedding
      appended per row, base features prepended
      (llava.cpp:clip_llava_handle_patches).
    - flat: base + tiles concatenated.

    Returns (n_embeds, proj_dim) f32 (numpy).
    """
    tiles, (gy, gx), orig_hw = preprocess_anyres(img, cfg)
    emb = encode_image(cfg, params, tiles).cpu().numpy()
    base, patches = emb[0], emb[1:]
    if cfg.mm_patch_merge_type != "spatial_unpad" or patches.size == 0:
        return np.concatenate([base] + list(patches))
    ph = pw = cfg.image_size // cfg.patch_size
    d = emb.shape[-1]
    spat = patches.reshape(gy, gx, ph, pw, d) \
                  .transpose(0, 2, 1, 3, 4).reshape(gy * ph, gx * pw, d)
    spat = _unpad_spatial(spat, orig_hw)
    nl = params.get("image_newline")
    if nl is not None:
        nl = (nl.cpu().numpy() if isinstance(nl, torch.Tensor)
              else np.asarray(nl))
        col = np.broadcast_to(nl.astype(np.float32), (spat.shape[0], 1, d))
        spat = np.concatenate([spat, col], axis=1)
    return np.concatenate([base, spat.reshape(-1, d)])
