"""VGGT in the port (styl3r_tpu_torch/models/vggt.py) against the plain
float32 reference (tests/vggt_reference.py, which imports nothing of either
package) on seeded random weights, on the CPU at a tiny size: dim 32, 2
heads, 2 frame + 2 global blocks, patch 14, 2-3 frames of 28x42. Both sides
compute in float32, the port through its own attention and RoPE paths and
the reference through written-out softmax and table-lookup RoPE, so they
agree to rounding (relative 1e-5).

Also: the special tokens' positions and frame-0 choice, the camera head's
refinements, the DPT heads' activations, the key names of VGGT-1B against a
listing of the released checkpoint's, the pose encoding's conversion, the
registry, the checkpoint loader, the inference entry's --tiny run, CroCo's
blocks with QK-norm and LayerScale off, and (on a card) the kernel RoPE and a
fused SDPA backend under bf16 autocast."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from styl3r_tpu_torch.models import vggt as V
from styl3r_tpu_torch.models import vit
from styl3r_tpu_torch.models.registry import get_model
from styl3r_tpu_torch.utils import trace

import vggt_reference as R

TINY = dict(V.VGGT_1B, img_size=28, embed_dim=32, depth=2, num_heads=2, patch_embed_depth=2, camera_trunk_depth=2,
            head_features=16, head_out_channels=(8, 8, 16, 16), head_layers=(0, 1, 1, 1), frames_chunk_size=2)
TOL = 1e-5


def rel(a, b):
    return float((a - b).norm() / b.norm())


def pair(seed=3, **widths):
    """(port, reference) at `widths` with the reference's weights in both."""
    w = dict(TINY, **widths)
    ref = R.draw(seed, "cpu", **w)
    port = V.VGGT(**w, seed=seed + 1)
    port.load_state_dict(ref.state_dict())
    return port.eval(), ref


def images(s, h=28, w=42, seed=0):
    return torch.rand(1, s, 3, h, w, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("frames", [2, 3])
def test_the_whole_forward_matches_the_reference(frames):
    port, ref = pair()
    x = images(frames)
    with torch.no_grad():
        a, b = port(x), ref(x)
    assert set(a) == set(b)
    assert a["depth"].shape == (1, frames, 28, 42, 1) and a["world_points"].shape == (1, frames, 28, 42, 3)
    assert a["depth_conf"].shape == a["world_points_conf"].shape == (1, frames, 28, 42)
    assert a["pose_enc"].shape == (1, frames, 9)
    for key in ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf"):
        assert a[key].dtype == torch.float32
        assert rel(a[key], b[key]) < TOL, key


def test_special_tokens_sit_at_the_origin_and_frame_zero_takes_index_zero():
    pos = V.token_positions(2, 3, 2, 3, 5, "cpu")
    assert pos.dtype == torch.int32 and pos.shape == (6, 5 + 6, 2)
    assert (pos[:, :5] == 0).all()
    assert pos[0, 5:].tolist() == [[y + 1, x + 1] for y in range(2) for x in range(3)]
    tokens = torch.stack([torch.full((4, 8), 0.0), torch.full((4, 8), 1.0)])[None]  # (1, 2, 4, 8)
    flat = V.slice_expand_and_flatten(tokens, 2, 3)
    assert flat.shape == (6, 4, 8)
    assert flat[:, 0, 0].tolist() == [0.0, 1.0, 1.0, 0.0, 1.0, 1.0]  # frame 0 of each scene takes index 0
    # A frame's answer depends on whether it is first: the same images in
    # another order give other cameras for the frame that moved.
    port, _ = pair()
    x = images(3)
    with torch.no_grad():
        a = port(x)["pose_enc"][0]
        b = port(x[:, [1, 0, 2]])["pose_enc"][0]
    assert not torch.allclose(a[0], b[1], atol=1e-4)


def test_the_camera_heads_refinements_match_the_reference():
    port, ref = pair(seed=5)
    last = torch.randn(1, 3, 17, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = port.camera_head(last), ref.camera_head(last)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert rel(x, y) < TOL
        assert (x[..., 7:] >= 0).all()  # the FoV through its ReLU
    assert not torch.allclose(a[0], a[-1])  # each refinement moves the encoding


def test_the_dpt_heads_activations():
    out = torch.randn(2, 4, 3, 5, generator=torch.Generator().manual_seed(2))
    values, conf = V.activate_head(out, "inv_log")
    x = out.permute(0, 2, 3, 1)
    assert torch.allclose(values, torch.sign(x[..., :3]) * (torch.exp(x[..., :3].abs()) - 1), atol=1e-6)
    assert torch.allclose(conf, 1 + torch.exp(x[..., 3]))
    values, conf = V.activate_head(out[:, :2], "exp")
    assert values.shape == (2, 3, 5, 1) and torch.allclose(values[..., 0], torch.exp(x[..., 0]))
    assert (conf > 1).all()
    port, ref = pair(seed=7)
    layers = [torch.randn(1, 3, 5 + 6, 64, generator=torch.Generator().manual_seed(k)) for k in range(2)]
    with torch.no_grad():
        for name in ("depth_head", "point_head"):
            a = getattr(port, name)(layers, (28, 42), 5)
            b = getattr(ref, name)(layers, 28, 42, 5)
            assert rel(a[0], b[0]) < TOL and rel(a[1], b[1]) < TOL


# Keys of the released VGGT-1B checkpoint (model.pt), a sample of each
# module group, with their shapes.
RELEASED_KEYS = {
    "aggregator.camera_token": (1, 2, 1, 1024),
    "aggregator.register_token": (1, 2, 4, 1024),
    "aggregator.patch_embed.cls_token": (1, 1, 1024),
    "aggregator.patch_embed.pos_embed": (1, 1370, 1024),
    "aggregator.patch_embed.register_tokens": (1, 4, 1024),
    "aggregator.patch_embed.mask_token": (1, 1024),
    "aggregator.patch_embed.patch_embed.proj.weight": (1024, 3, 14, 14),
    "aggregator.patch_embed.blocks.0.norm1.weight": (1024,),
    "aggregator.patch_embed.blocks.0.attn.qkv.weight": (3072, 1024),
    "aggregator.patch_embed.blocks.23.ls1.gamma": (1024,),
    "aggregator.patch_embed.blocks.23.mlp.fc1.weight": (4096, 1024),
    "aggregator.patch_embed.norm.bias": (1024,),
    "aggregator.frame_blocks.0.attn.q_norm.weight": (64,),
    "aggregator.frame_blocks.0.attn.k_norm.bias": (64,),
    "aggregator.frame_blocks.0.attn.proj.weight": (1024, 1024),
    "aggregator.frame_blocks.23.ls2.gamma": (1024,),
    "aggregator.global_blocks.0.attn.qkv.bias": (3072,),
    "aggregator.global_blocks.23.mlp.fc2.weight": (1024, 4096),
    "camera_head.trunk.0.attn.qkv.weight": (6144, 2048),
    "camera_head.trunk.3.ls1.gamma": (2048,),
    "camera_head.token_norm.weight": (2048,),
    "camera_head.trunk_norm.bias": (2048,),
    "camera_head.empty_pose_tokens": (1, 1, 9),
    "camera_head.embed_pose.weight": (2048, 9),
    "camera_head.poseLN_modulation.1.weight": (6144, 2048),
    "camera_head.pose_branch.fc1.weight": (1024, 2048),
    "camera_head.pose_branch.fc2.weight": (9, 1024),
    "depth_head.norm.weight": (2048,),
    "depth_head.projects.0.weight": (256, 2048, 1, 1),
    "depth_head.projects.3.weight": (1024, 2048, 1, 1),
    "depth_head.resize_layers.0.weight": (256, 256, 4, 4),
    "depth_head.resize_layers.1.weight": (512, 512, 2, 2),
    "depth_head.resize_layers.3.weight": (1024, 1024, 3, 3),
    "depth_head.scratch.layer4_rn.weight": (256, 1024, 3, 3),
    "depth_head.scratch.refinenet1.resConfUnit1.conv1.weight": (256, 256, 3, 3),
    "depth_head.scratch.refinenet4.resConfUnit2.conv2.bias": (256,),
    "depth_head.scratch.refinenet4.out_conv.weight": (256, 256, 1, 1),
    "depth_head.scratch.output_conv1.weight": (128, 256, 3, 3),
    "depth_head.scratch.output_conv2.0.weight": (32, 128, 3, 3),
    "depth_head.scratch.output_conv2.2.weight": (2, 32, 1, 1),
    "point_head.scratch.output_conv2.2.weight": (4, 32, 1, 1),
}


def test_key_names_are_vggts():
    model = get_model("vggt", device="meta")
    sd = model.state_dict()
    for key, shape in RELEASED_KEYS.items():
        assert tuple(sd[key].shape) == shape, key
    assert not any("refinenet4.resConfUnit1" in k or k.startswith("track_head.") for k in sd)
    assert sum(p.numel() for p in model.parameters()) == 1_190_596_120
    with torch.device("meta"):
        ref = R.VGGTReference(**V.VGGT_1B)
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}


def test_a_released_checkpoint_loads_without_its_tracking_head(tmp_path):
    from styl3r_tpu_torch.utils.checkpoint import load_checkpoint

    port, ref = pair(seed=11)
    sd = dict(ref.state_dict(), **{"track_head.fnet.conv1.weight": torch.zeros(2, 3)})
    torch.save(sd, tmp_path / "model.pt")
    fresh = V.VGGT(**TINY, seed=0)
    load_checkpoint(fresh, str(tmp_path / "model.pt"))
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), port.state_dict().values()))
    with pytest.raises(ValueError):
        get_model("vggt-2")


def test_pose_encoding_to_extrinsics_and_intrinsics():
    half = math.sqrt(0.5)
    enc = torch.tensor([[[1.0, 2.0, 3.0, 0.0, 0.0, half, half, 2 * math.atan(0.5), 2 * math.atan(0.25)]]])
    ext, k = V.pose_encoding_to_extri_intri(enc, (40, 60))
    rot = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])  # 90 degrees about z
    assert torch.allclose(ext[0, 0, :, :3], rot, atol=1e-6)
    assert ext[0, 0, :, 3].tolist() == [1.0, 2.0, 3.0]
    assert torch.allclose(k[0, 0], torch.tensor([[120.0, 0, 30], [0, 40.0, 20], [0, 0, 1]]), atol=1e-4)
    r = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))
    m = V.quat_to_mat(r)
    assert torch.allclose(m @ m.transpose(-1, -2), torch.eye(3).expand(5, 3, 3), atol=1e-5)


def test_the_entry_point_runs_tiny(tmp_path):
    from PIL import Image

    from styl3r_tpu_torch.infer import vggt as entry

    rng = np.random.default_rng(0)
    (tmp_path / "in").mkdir()
    for i, (h, w) in enumerate([(30, 40), (30, 40)]):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(tmp_path / "in" / f"{i}.png")
    assert entry.crop_preprocess(rng.random((60, 40, 3)).astype(np.float32)).shape == (3, 518, 518)
    if not torch.cuda.is_available():  # the port's rule: no quiet fall back to the CPU
        with pytest.raises(RuntimeError):
            entry.main(["--images", str(tmp_path / "in"), "--out", str(tmp_path / "out"), "--tiny"])
    summary = entry.main(["--images", str(tmp_path / "in"), "--out", str(tmp_path / "out"), "--tiny", "--cpu"])
    assert summary["views"] == 2 and summary["image_hw"] == [392, 518] and summary["points"] > 0
    cams = json.loads((tmp_path / "out" / "cameras.json").read_text())["cameras"]
    assert len(cams) == 2 and np.asarray(cams[0]["extrinsics"]).shape == (3, 4)
    assert np.load(tmp_path / "out" / "depth.npy").shape == (2, 392, 518)
    from styl3r_tpu_torch.utils.ply_export import load_ply

    assert len(load_ply(tmp_path / "out" / "points.ply")["x"]) == summary["points"]


def test_crocos_blocks_with_qk_norm_and_layer_scale_off_compute_as_before():
    """vit.Block without QK-norm and LayerScale is the parent's block: the
    same keys and, bit for bit, x + attn(ln(x)), x + mlp(ln(x)) with RoPE
    and SDPA called as before."""
    torch.manual_seed(0)
    blk = vit.Block(32, 2, rope_base=100.0).eval()
    assert sorted(blk.state_dict()) == sorted(
        f"{m}.{p}" for m in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
        for p in ("weight", "bias"))
    x = torch.randn(2, 6, 32)
    pos = vit.token_grid_positions(2, 3)[None].expand(2, -1, -1).contiguous()
    from styl3r_tpu_torch.ops.rope import rope2d_qk

    def parent(x):
        h = blk.norm1(x)
        q, k, v = blk.attn.qkv(h).reshape(2, 6, 3, 2, 16).unbind(2)
        q, k = rope2d_qk(q, pos, k, pos, 100.0)
        out = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=16**-0.5).transpose(1, 2)
        x = x + blk.attn.proj(out.reshape(2, 6, 32))
        return x + blk.mlp(blk.norm2(x))

    with torch.no_grad():
        assert torch.equal(blk(x, pos), parent(x))


@pytest.mark.cuda
def test_on_the_card_rope_takes_the_kernel_and_the_attention_a_fused_backend():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    port, ref = pair(seed=13)
    port.to(dev).compute_dtype = torch.bfloat16
    ref.to(dev)
    x = images(3, seed=4).to(dev)
    trace.reset()
    from torch.profiler import ProfilerActivity, profile

    from styl3r_tpu_torch.ops.attention import dot_product_attention

    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            a = port(x)
            torch.cuda.synchronize()
        launches = trace.counters()["rope2d"]
        b = ref(x)
        q = torch.randn(1, 8, 2, 16, dtype=torch.float64, device=dev)
        with pytest.raises(RuntimeError):
            dot_product_attention(q, q, q)  # no fused backend takes float64: no fallback
        assert torch.backends.cuda.math_sdp_enabled()  # the math backend's flag is restored
    names = [e.name.lower() for e in prof.events() if e.device_type.name == "CUDA"]
    assert any(s in n for n in names for s in ("flash", "fmha", "cudnn")), sorted(set(names))[:40]
    assert launches == 2 * TINY["depth"]
    for key in ("pose_enc", "depth", "world_points"):
        assert rel(a[key], b[key]) < 0.1, key
