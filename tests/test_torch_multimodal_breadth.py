"""Multimodal breadth on the port, held against the JAX package on the CPU.

Every case of the reference's ``tests/test_multimodal_breadth.py`` runs
through ``smg_tpu_torch.multimodal`` and through ``smg_tpu.multimodal`` on
the same seeded input, with the reference test's own assertions; then:

- the registry: ``get_image_processor`` and ``processor_for_worker`` for
  every ``_MODEL_MAP`` name and an unknown one (LLaVA's and the smart-resize
  fallbacks), with and without a worker's geometry: the reference's class
  and every attribute but ``device``;
- ``process()`` of all ten processors over seeded sizes that reach
  InternVL's area gate, Kimi-K2.5's zero padding, Pixtral's cap and the
  tilings' ratio ties: grid, placeholder count and ``llm_grid`` exact,
  pixels within ``REF_PIXEL_ATOL`` of the 0-255 input over the
  processor's smallest std.  ``test_torch_vision`` holds small images to
  1e-3; at these sizes ``jax.image.resize`` on the CPU is itself up to
  7.8e-3 off the float64 product of its own weights (the port's resize
  2.9e-5), which ``test_resize_against_float64_at_processor_sizes`` shows;
- audio: ``decode_wav`` (8, 16, 24 and 32 bits, stereo), ``resample``,
  ``mel_filterbank`` and ``log_mel_spectrogram`` to 1e-5, the Whisper and
  Qwen2-Audio processors and their registry;
- video: the same frame indices, GIF frames and pixels;
- the pixel cache's fingerprints, equal to the reference's whatever the
  processor's device;
- an image chat for each family's model name over a tiny VLM (patch 56,
  merge 2) through the port's app and the reference's ``build_app``:
  identical statuses and bodies (ids removed), the 502 "encode returned N
  embeddings for M placeholder tokens" of the families whose placeholder
  count is not the 2x2-merging tower's row count included.

Float32 on the CPU."""

import asyncio
import base64
import dataclasses
import io
import struct
import wave
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway.worker_client import InProcWorkerClient as JaxInProc
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.models import config as jmodels
from smg_tpu.models import llama as jl
from smg_tpu.models import vit as jvit
from smg_tpu.multimodal import audio as jaudio
from smg_tpu.multimodal import image as jimage
from smg_tpu.multimodal import pixel_cache as jpc
from smg_tpu.multimodal import processor as jproc
from smg_tpu.multimodal import video as jvideo
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
from smg_tpu_torch.gateway.workers import Worker
from smg_tpu_torch.models import config as tmodels
from smg_tpu_torch.models.convert import params_from_jax, vision_params_from_jax
from smg_tpu_torch.multimodal import audio as taudio
from smg_tpu_torch.multimodal import image as timage
from smg_tpu_torch.multimodal import pixel_cache as tpc
from smg_tpu_torch.multimodal import processor as tproc
from smg_tpu_torch.multimodal import video as tvideo
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
PIXEL_ATOL = 1e-3  # resized pixels, in units of the 0-255 input (test_torch_vision)
# the same against the reference at the processors' sizes: its resize's own
# error reaches 7.8e-3 there (test_resize_against_float64_at_processor_sizes)
REF_PIXEL_ATOL = 1e-2
AUDIO_ATOL = 1e-5
# one model name of each family, and a name of none (the fallbacks)
FAMILY_MODELS = {
    "qwen2_vl": "Qwen/Qwen2-VL-7B", "llava": "llava-hf/llava-1.5",
    "internvl": "OpenGVLab/InternVL2-8B", "pixtral": "mistralai/Pixtral-12B",
    "gemma3": "google/gemma-3-12b-it", "phi3_v": "microsoft/Phi-3.5-vision",
    "llama4": "meta-llama/Llama-4-Scout", "phi4_v": "microsoft/Phi-4-multimodal",
    "kimi_k25": "moonshotai/Kimi-K2.5", "qwen3_omni": "Qwen/Qwen3-Omni-30B",
}
UNKNOWN = "acme/some-vlm"


def _img(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


def _attrs(proc) -> dict:
    return {k: v for k, v in vars(proc).items() if k != "device"}


def _pair(name: str, **kw):
    """(port processor on the CPU, reference processor) of one class."""
    return getattr(tproc, name)(device="cpu", **kw), getattr(jproc, name)(**kw)


def _std(proc) -> float:
    return 0.5 if proc.name in ("llama4", "phi4_v", "kimi_k25") else min(jimage.DEFAULT_STD)


def assert_same_processed(got, want, proc) -> None:
    assert (got.grid, got.num_placeholder_tokens, got.llm_grid) == \
        (want.grid, want.num_placeholder_tokens, want.llm_grid)
    assert got.pixel_values.dtype == torch.float32
    np.testing.assert_allclose(got.pixel_values.numpy(), np.asarray(want.pixel_values),
                               rtol=0, atol=REF_PIXEL_ATOL / 255.0 / _std(proc))


def _both(name: str, img, **kw):
    tp, jp = _pair(name, **kw)
    got, want = tp.process(img), jp.process(img)
    assert_same_processed(got, want, tp)
    return got


# ---- the reference's cases, each through both packages ----


def test_processor_registry_families():
    for model, cls in [("OpenGVLab/InternVL2-8B", "InternVLImageProcessor"),
                       ("mistralai/Pixtral-12B", "PixtralImageProcessor"),
                       ("google/gemma-3-12b-it", "Gemma3ImageProcessor"),
                       ("microsoft/Phi-3.5-vision", "Phi3VisionImageProcessor"),
                       ("Qwen/Qwen2-VL-7B", "Qwen2VLImageProcessor"),
                       ("llava-hf/llava-1.5", "LlavaImageProcessor")]:
        got = tproc.get_image_processor(model, device="cpu")
        assert isinstance(got, getattr(tproc, cls))
        assert type(jproc.get_image_processor(model)).__name__ == cls


def test_internvl_tiling_counts():
    out = _both("InternVLImageProcessor", _img(300, 600), tile_size=448, patch_size=14,
                merge_size=2, max_tiles=6)
    g = 448 // 14
    assert out.num_placeholder_tokens == 3 * (g // 2) ** 2  # 2 tiles + thumbnail
    assert tuple(out.pixel_values.shape) == (3 * g * g, 14 * 14 * 3)
    out2 = _both("InternVLImageProcessor", _img(100, 100), max_tiles=1)
    assert out2.num_placeholder_tokens == 256


def test_pixtral_aspect_preserved():
    out = _both("PixtralImageProcessor", _img(512, 256), max_size=256, patch_size=16)
    assert out.grid == (16, 8) and out.num_placeholder_tokens == 128
    assert out.pixel_values.shape[0] == 128


def test_gemma3_fixed_budget():
    assert _both("Gemma3ImageProcessor", _img(123, 777)).num_placeholder_tokens == 256


def test_phi3_hd_views():
    kw = dict(base=336, patch_size=14, max_crops=4)
    out = _both("Phi3VisionImageProcessor", _img(336, 672), **kw)
    g = 336 // 14
    assert out.pixel_values.shape[0] == out.grid[0] * out.grid[1] and out.grid[1] == g
    assert out.num_placeholder_tokens == (out.grid[0] // g) * (g * g) // 4
    out2 = _both("Phi3VisionImageProcessor", _img(200, 200), **kw)
    assert out2.grid == (5 * g, g) and out2.pixel_values.shape[0] == 5 * g * g


def _tone(freq=440.0, secs=1.0, rate=16000):
    t = np.arange(int(secs * rate)) / rate
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _wav_bytes(x, rate=16000, width=2, channels=1):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        if width == 1:
            w.writeframes(((x * 127) + 128).astype(np.uint8).tobytes())
        elif width == 2:
            w.writeframes((x * 32767).astype("<i2").tobytes())
        elif width == 3:
            v = (x * (2 ** 23 - 1)).astype("<i4")
            w.writeframes(b"".join(int(s).to_bytes(3, "little", signed=True) for s in v))
        else:
            w.writeframes((x * (2 ** 31 - 1)).astype("<i4").tobytes())
    return buf.getvalue()


def test_wav_decode_roundtrip():
    x = _tone()
    raw = _wav_bytes(x)
    (y, rate), (want, wrate) = taudio.decode_wav(raw), jaudio.decode_wav(raw)
    assert rate == wrate == 16000 and y.dtype == want.dtype
    np.testing.assert_allclose(y, want, rtol=0, atol=AUDIO_ATOL)
    np.testing.assert_allclose(y, x, atol=1e-3)


def test_resample_preserves_tone():
    x = _tone(rate=8000)
    y = taudio.resample(x, 8000, 16000)
    np.testing.assert_allclose(y, jaudio.resample(x, 8000, 16000), rtol=0, atol=AUDIO_ATOL)
    assert abs(len(y) - 2 * len(x)) <= 1
    spec = np.abs(np.fft.rfft(y))
    assert abs(np.argmax(spec) * 16000 / len(y) - 440.0) < 5


def test_log_mel_against_torch_stft():
    """The port's log-mel equals the reference's; its power spectrogram
    under the same framing matches ``torch.stft``, and the mel bin of 1 kHz
    carries the peak energy."""
    x = _tone(freq=1000.0)
    n_fft, hop = 400, 160
    feats = taudio.log_mel_spectrogram(x)
    np.testing.assert_allclose(feats, jaudio.log_mel_spectrogram(x), rtol=0, atol=AUDIO_ATOL)
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    xp = np.pad(x, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(xp) - n_fft) // hop
    frames = np.lib.stride_tricks.as_strided(
        xp, shape=(n_frames, n_fft), strides=(xp.strides[0] * hop, xp.strides[0]))
    ours_power = np.abs(np.fft.rfft(frames * window, axis=1).T) ** 2
    t_spec = torch.stft(torch.from_numpy(x), n_fft, hop_length=hop,
                        window=torch.from_numpy(window), center=True, pad_mode="reflect",
                        return_complex=True)
    t_power = (t_spec.abs() ** 2).numpy()[:, :ours_power.shape[1]]
    np.testing.assert_allclose(ours_power, t_power, rtol=1e-3, atol=1e-4)
    assert feats.shape[0] == 80
    fb = taudio.mel_filterbank(80, n_fft, 16000)
    onek_bin = np.argmax(fb[:, int(1000 * n_fft / 16000)])
    assert abs(int(np.argmax(feats.mean(axis=1))) - int(onek_bin)) <= 1


def test_whisper_processor_shapes():
    feats, tokens = taudio.WhisperAudioProcessor().process(_tone(secs=2.0))
    want, wtokens = jaudio.WhisperAudioProcessor().process(_tone(secs=2.0))
    np.testing.assert_allclose(feats, want, rtol=0, atol=AUDIO_ATOL)
    assert feats.shape == (80, 3000) and tokens == wtokens == 1500


def test_qwen2_audio_variable_length():
    feats, tokens = taudio.Qwen2AudioProcessor().process(_tone(secs=2.0))
    want, wtokens = jaudio.Qwen2AudioProcessor().process(_tone(secs=2.0))
    np.testing.assert_allclose(feats, want, rtol=0, atol=AUDIO_ATOL)
    assert feats.shape[0] == 128 and 190 <= feats.shape[1] <= 210
    assert tokens == wtokens == feats.shape[1] // 2


def test_audio_bytes_path():
    raw = _wav_bytes(_tone())
    feats, tokens = taudio.WhisperAudioProcessor().process_bytes(raw)
    want, wtokens = jaudio.WhisperAudioProcessor().process_bytes(raw)
    np.testing.assert_allclose(feats, want, rtol=0, atol=AUDIO_ATOL)
    assert feats.shape == (80, 3000) and tokens == wtokens == 1500


def test_video_sampling_and_tokens():
    frames = [_img(64, 64, seed=i) for i in range(20)]
    picked = tvideo.sample_frames(frames, 8)
    assert [id(f) for f in picked] == [id(f) for f in jvideo.sample_frames(frames, 8)]
    assert len(picked) == 8 and picked[0] is frames[0] and picked[-1] is frames[-1]
    got = tvideo.VideoProcessor(tproc.Qwen2VLImageProcessor(patch_size=4, merge_size=2,
                                                            device="cpu"),
                                num_frames=4).process(frames)
    want = jvideo.VideoProcessor(jproc.Qwen2VLImageProcessor(patch_size=4, merge_size=2),
                                 num_frames=4).process(frames)
    assert (got.num_frames, got.frame_grids, got.num_placeholder_tokens) == \
        (want.num_frames, want.frame_grids, want.num_placeholder_tokens)
    assert got.num_frames == 4 and got.num_placeholder_tokens // 4 >= 1
    np.testing.assert_allclose(got.pixel_values.numpy(), np.asarray(want.pixel_values),
                               rtol=0, atol=REF_PIXEL_ATOL / 255.0 / min(jimage.DEFAULT_STD))


def _gif(n, h=16, w=16):
    from PIL import Image

    frames = [Image.fromarray(_img(h, w, seed=i)) for i in range(n)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:], duration=50)
    return buf.getvalue()


def test_video_gif_decode():
    raw = _gif(5)
    got, want = tvideo.decode_video_bytes(raw), jvideo.decode_video_bytes(raw)
    assert len(got) == len(want) == 5 and got[0].shape == (16, 16, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(tvideo.decode_video_bytes(raw, max_frames=3)) == 3
    with pytest.raises(Exception) as e_port:
        tvideo.decode_video_bytes(b"not an image")
    with pytest.raises(Exception) as e_ref:
        jvideo.decode_video_bytes(b"not an image")
    assert type(e_port.value) is type(e_ref.value)


def test_r5_processor_registry():
    for model, cls in [("meta-llama/Llama-4-Scout", "Llama4VisionProcessor"),
                       ("microsoft/Phi-4-multimodal", "Phi4VisionProcessor"),
                       ("moonshotai/Kimi-K2.5", "KimiK25ImageProcessor"),
                       ("Qwen/Qwen3-Omni-30B", "Qwen3OmniVisionProcessor"),
                       ("microsoft/Phi-3.5-vision", "Phi3VisionImageProcessor")]:
        assert isinstance(tproc.get_image_processor(model, device="cpu"), getattr(tproc, cls))
        assert type(jproc.get_image_processor(model)).__name__ == cls


def test_llama4_tiling_tokens():
    assert _both("Llama4VisionProcessor", _img(336, 336)).num_placeholder_tokens == 576
    out2 = _both("Llama4VisionProcessor", _img(336, 672))
    assert out2.num_placeholder_tokens == 3 * 576
    assert out2.pixel_values.shape[0] == 3 * (336 // 14) ** 2


def test_phi4_token_formula():
    out = _both("Phi4VisionProcessor", _img(448, 896), dynamic_hd=4)
    assert out.num_placeholder_tokens == 256 + 1 + 256 * 3 + 16 + 16
    sq = _both("Phi4VisionProcessor", _img(448, 448), dynamic_hd=4)
    assert sq.num_placeholder_tokens == 256 + 1 + 256 * 4 + 16 * 2 + 16


def test_kimi_zero_pads_not_resizes():
    out = _both("KimiK25ImageProcessor", _img(30, 45))
    gh, gw = out.grid
    assert (gh, gw) == (4, 4) and out.llm_grid == (2, 2)
    assert out.num_placeholder_tokens == 4
    # the padding is zeros: the last patch row lies wholly below the image
    pv = out.pixel_values.numpy().reshape(gh, gw, 14, 14, 3)
    assert (pv[3] == 0).all() and (pv[:, 3, :, 3:] == 0).all()
    tp, jp = _pair("KimiK25ImageProcessor")
    big_img = _img(14 * 600, 14 * 20)
    big, want = tp.process(big_img), jp.process(big_img)
    assert_same_processed(big, want, tp)
    assert big.grid[0] <= tp.side_patch_limit


def test_qwen3_omni_patch16():
    out = _both("Qwen3OmniVisionProcessor", _img(128, 128))
    assert out.llm_grid is not None and out.pixel_values.shape[1] == 16 * 16 * 3


def test_pixel_cache_lru_and_keys():
    part_a = {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}
    part_b = {"type": "image_url", "image_url": {"url": "data:image/png;base64,BBBB"}}
    assert tpc.image_source_hash(part_a) == jpc.image_source_hash(part_a)
    assert tpc.image_source_hash(part_a) != tpc.image_source_hash(part_b)
    fp1 = tpc.processor_fingerprint(tproc.Qwen2VLImageProcessor(patch_size=14, device="cpu"))
    fp2 = tpc.processor_fingerprint(tproc.Qwen2VLImageProcessor(patch_size=16, device="cpu"))
    assert fp1 != fp2
    assert fp1 == jpc.processor_fingerprint(jproc.Qwen2VLImageProcessor(patch_size=14))
    caches = {"port": tpc.PixelCache(max_bytes=3000), "ref": jpc.PixelCache(max_bytes=3000)}
    trace = {}
    for side, cache in caches.items():
        e1 = (np.zeros((4, 256), np.float32), (2, 2), 4, None)  # over the cap: skipped
        cache.put(("k1", fp1), e1)
        steps = [cache.get(("k1", fp1)) is None]
        small = (np.zeros((1, 128), np.float32), (1, 1), 1, None)
        cache.put(("k1", fp1), small)
        steps += [cache.get(("k1", fp1)) is not None, cache.stats()["hits"]]
        for i in range(10):
            cache.put((f"k{i}", fp1), small)
        steps += [cache.size_bytes <= 3000, cache.get(("k1", fp1)) is None, cache.stats()]
        trace[side] = steps
    assert trace["port"] == trace["ref"]
    assert trace["port"][:5] == [True, True, 1, True, True]


def test_pixel_cache_env_gate(monkeypatch):
    for pc in (tpc, jpc):
        monkeypatch.setattr(pc, "_global", None)
        monkeypatch.delenv("SMG_MM_PIXEL_CACHE_MB", raising=False)
        assert pc.get_pixel_cache() is None
        monkeypatch.setenv("SMG_MM_PIXEL_CACHE_MB", "8")
        monkeypatch.setattr(pc, "_global", None)
        c = pc.get_pixel_cache()
        assert c is not None and c.max_bytes == 8 * 2**20
        monkeypatch.setattr(pc, "_global", None)


# ---- the registry, every name ----


REGISTRY_NAMES = ([sub for sub, _ in jproc._MODEL_MAP] + list(jproc._PROCESSORS)
                  + list(FAMILY_MODELS.values()) + [UNKNOWN, ""])


@pytest.mark.parametrize("name", REGISTRY_NAMES)
def test_registry_matches_reference_for_every_name(name):
    got, want = tproc.get_image_processor(name, device="cpu"), jproc.get_image_processor(name)
    assert type(got).__name__ == type(want).__name__ and _attrs(got) == vars(want)
    for geometry in ({}, {"patch_size": 14, "merge_size": 2}, {"patch_size": 4,
                                                                "merge_size": 2}):
        got = tproc.processor_for_worker(name, device="cpu", **geometry)
        want = jproc.processor_for_worker(name, **geometry)
        assert type(got).__name__ == type(want).__name__ and _attrs(got) == vars(want)
    assert tproc._MODEL_MAP == jproc._MODEL_MAP
    assert {k: v.__name__ for k, v in tproc._PROCESSORS.items()} == \
        {k: v.__name__ for k, v in jproc._PROCESSORS.items()}


# ---- process() of every processor ----


PROCESS_CASES = [
    ("Qwen2VLImageProcessor", {}, (64, 64)),
    ("Qwen2VLImageProcessor", {"max_pixels": 56 * 56 * 4}, (200, 90)),
    ("LlavaImageProcessor", {}, (90, 200)),
    ("LlavaImageProcessor", {"image_size": 56, "patch_size": 14}, (300, 30)),
    ("InternVLImageProcessor", {}, (64, 64)),
    ("InternVLImageProcessor", {"tile_size": 56, "max_tiles": 6}, (120, 120)),  # area gate
    ("InternVLImageProcessor", {"tile_size": 56, "max_tiles": 6}, (40, 40)),  # no room
    ("InternVLImageProcessor", {"tile_size": 56}, (90, 200)),
    ("InternVLImageProcessor", {"tile_size": 56, "use_thumbnail": False}, (60, 130)),
    ("PixtralImageProcessor", {}, (64, 64)),
    ("PixtralImageProcessor", {"max_size": 128}, (200, 90)),  # the cap
    ("PixtralImageProcessor", {"max_size": 128, "patch_size": 14}, (7, 300)),
    ("Gemma3ImageProcessor", {"image_size": 112}, (90, 200)),
    ("Gemma3ImageProcessor", {"image_size": 112, "merge_size": 2}, (64, 64)),
    ("Phi3VisionImageProcessor", {}, (64, 64)),
    ("Phi3VisionImageProcessor", {"base": 56}, (90, 200)),
    ("Phi3VisionImageProcessor", {"base": 56, "max_crops": 9}, (200, 90)),
    ("Llama4VisionProcessor", {"tile_size": 56}, (120, 120)),  # tie: more tiles
    ("Llama4VisionProcessor", {"tile_size": 56}, (40, 40)),  # tie: one tile
    ("Llama4VisionProcessor", {"tile_size": 56, "max_tiles": 6}, (90, 200)),
    ("Phi4VisionProcessor", {"base": 56}, (90, 200)),
    ("Phi4VisionProcessor", {"base": 56, "dynamic_hd": 4}, (64, 64)),
    ("KimiK25ImageProcessor", {}, (90, 200)),  # padded
    ("KimiK25ImageProcessor", {"side_patch_limit": 8}, (200, 90)),  # scaled, then padded
    ("KimiK25ImageProcessor", {"in_patch_limit": 16}, (64, 64)),  # the area cap
    ("Qwen3OmniVisionProcessor", {}, (90, 200)),
    ("Qwen3OmniVisionProcessor", {"max_pixels": 64 * 64 * 4}, (300, 200)),
]


@pytest.mark.parametrize("name,kw,hw", PROCESS_CASES,
                         ids=[f"{n[:-9]}-{i}" for i, (n, _, _) in enumerate(PROCESS_CASES)])
def test_process_matches_reference(name, kw, hw):
    _both(name, _img(*hw, seed=hw[0] * 7 + hw[1]), **kw)


def test_fingerprints_match_reference_whatever_the_device():
    for name in FAMILY_MODELS.values():
        want = jpc.processor_fingerprint(jproc.processor_for_worker(name, 14, 2))
        for device in ("cpu", torch.device("cpu"), None):
            assert tpc.processor_fingerprint(
                tproc.processor_for_worker(name, 14, 2, device=device)) == want


def test_video_process_bytes_matches_reference():
    raw = _gif(9, 40, 56)
    got = tvideo.VideoProcessor(tproc.processor_for_worker("kimi-vl", 14, 2, device="cpu"),
                                num_frames=4).process_bytes(raw)
    want = jvideo.VideoProcessor(jproc.processor_for_worker("kimi-vl", 14, 2),
                                 num_frames=4).process_bytes(raw)
    assert (got.num_frames, got.frame_grids, got.num_placeholder_tokens) == \
        (want.num_frames, want.frame_grids, want.num_placeholder_tokens)
    np.testing.assert_allclose(got.pixel_values.numpy(), np.asarray(want.pixel_values),
                               rtol=0, atol=REF_PIXEL_ATOL / 255.0 / 0.5)


@pytest.mark.parametrize("src,dst", [((300, 600), (448, 896)), ((300, 600), (896, 1792)),
                                     ((336, 672), (336, 1008)), ((768, 1024), (336, 336))],
                         ids=["internvl-tiles", "enlarge-3x", "phi3-crops", "shrink"])
def test_resize_against_float64_at_processor_sizes(src, dst):
    """At the processors' sizes the port's resize stays within PIXEL_ATOL of
    the float64 product of the resize weights (the same weights as JAX's),
    and the reference's within REF_PIXEL_ATOL."""
    img = _img(*src, seed=src[0])
    wh = timage.resize_weights(src[0], dst[0], "cpu").double()
    ww = timage.resize_weights(src[1], dst[1], "cpu").double()
    exact = torch.einsum("hwc,hH,wW->HWc", torch.tensor(img, dtype=torch.float64), wh,
                         ww).numpy()
    got = timage.resize_image(img, *dst, device="cpu").numpy()
    want = np.asarray(jimage.resize_image(jnp.asarray(img), *dst))
    np.testing.assert_allclose(got, exact, rtol=0, atol=PIXEL_ATOL)
    np.testing.assert_allclose(want, exact, rtol=0, atol=REF_PIXEL_ATOL)


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 2), (3, 1), (4, 2)])
def test_decode_wav_widths_match_reference(width, channels):
    x = np.random.default_rng(width).uniform(-0.9, 0.9, 800 * channels).astype(np.float32)
    raw = _wav_bytes(x, rate=8000, width=width, channels=channels)
    (y, rate), (want, wrate) = taudio.decode_wav(raw), jaudio.decode_wav(raw)
    assert rate == wrate == 8000 and y.shape == want.shape == (800,)
    np.testing.assert_allclose(y, want, rtol=0, atol=AUDIO_ATOL)


@pytest.mark.parametrize("n_mels,n_fft,rate", [(80, 400, 16000), (128, 400, 16000),
                                               (40, 512, 8000)])
def test_mel_filterbank_and_log_mel_match_reference(n_mels, n_fft, rate):
    np.testing.assert_allclose(taudio.mel_filterbank(n_mels, n_fft, rate),
                               jaudio.mel_filterbank(n_mels, n_fft, rate),
                               rtol=0, atol=AUDIO_ATOL)
    x = np.random.default_rng(n_mels).standard_normal(rate // 2).astype(np.float32) * 0.1
    np.testing.assert_allclose(taudio.log_mel_spectrogram(x, rate, n_fft, n_fft // 4, n_mels),
                               jaudio.log_mel_spectrogram(x, rate, n_fft, n_fft // 4, n_mels),
                               rtol=0, atol=AUDIO_ATOL)
    y = taudio.resample(x, rate, 11025)
    np.testing.assert_allclose(y, jaudio.resample(x, rate, 11025), rtol=0, atol=AUDIO_ATOL)


@pytest.mark.parametrize("name", ["whisper", "qwen2_audio", "Qwen/Qwen2-Audio-7B",
                                  "openai/whisper-large-v3", "", UNKNOWN])
def test_audio_registry_matches_reference(name):
    got, want = taudio.get_audio_processor(name), jaudio.get_audio_processor(name)
    assert type(got).__name__ == type(want).__name__ and vars(got) == vars(want)


# ---- an image chat of every family through both gateways ----


CHAT_PATCH = 56  # the tiny tower's patch: every family's views stay small
CHAT_IMAGE = (120, 240)


def _vlm_configs():
    jbase = jmodels.tiny_vlm_config()
    jcfg = dataclasses.replace(jbase, vision=dataclasses.replace(jbase.vision,
                                                                 patch_size=CHAT_PATCH))
    tbase = tmodels.tiny_vlm_config()
    tcfg = dataclasses.replace(tbase, vision=dataclasses.replace(tbase.vision,
                                                                 patch_size=CHAT_PATCH))
    return jcfg, tcfg


def _chat_engines():
    jcfg, tcfg = _vlm_configs()
    lm = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    tower = jax.tree.map(np.asarray, jvit.init_vision_params(jcfg.vision,
                                                             jax.random.PRNGKey(1)))
    sched = dict(max_batch_size=4, max_seq_len=256, max_prefill_tokens=64,
                 decode_batch_buckets=(4,))
    je = JaxEngine(jconf.EngineConfig(
        model=jcfg, cache=jconf.CacheConfig(page_size=16, num_pages=64, auto_size=False,
                                            dtype="float32"),
        scheduler=jconf.SchedulerConfig(prefill_token_buckets=(16, 32, 64), **sched),
        dtype="float32", seed=0, model_id="tiny-vlm"),
        tokenizer=JaxMockTokenizer(), params=jax.tree.map(jnp.asarray, lm),
        vision_params=jax.tree.map(jnp.asarray, tower))
    te = Engine(tconf.EngineConfig(
        model=tcfg, cache=tconf.CacheConfig(page_size=16, num_pages=64, auto_size=False,
                                            dtype="float32"),
        scheduler=tconf.SchedulerConfig(**sched), seed=0, model_id="tiny-vlm"),
        params=params_from_jax(lm), device="cpu", tokenizer=MockTokenizer(),
        vision_params=vision_params_from_jax(tower))
    return je, te


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _png_uri(arr) -> str:
    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + arr[r].tobytes() for r in range(h))
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    return "data:image/png;base64," + base64.b64encode(png).decode()


async def _chats(server, ctx, bodies) -> list:
    tc = TestClient(TestServer(server.build_app(ctx)))
    await tc.start_server()
    try:
        out = []
        for body in bodies:
            resp = await tc.post("/v1/chat/completions", json=body)
            out.append((resp.status, await resp.json()))
        return out
    finally:
        await tc.close()


def test_image_chat_of_every_family_answers_as_the_reference_gateway():
    uri = _png_uri(_img(*CHAT_IMAGE, seed=21))
    models = [*FAMILY_MODELS.values(), UNKNOWN]
    bodies = [{"model": m, "max_tokens": 6, "temperature": 0, "ignore_eos": True,
               "messages": [{"role": "user", "content": [
                   {"type": "text", "text": "w5 w6"},
                   {"type": "image_url", "image_url": {"url": uri}},
                   {"type": "text", "text": "w7"}]}]} for m in models]
    je, te = _chat_engines()
    jctx, tctx = jserver.AppContext(policy="round_robin"), tserver.AppContext(
        policy="round_robin")
    for i, m in enumerate(models):
        jctx.tokenizers.register(m, JaxMockTokenizer(), default=i == 0)
        jctx.registry.add(JaxWorker(worker_id=f"w{i}", client=JaxInProc(je), model_id=m))
        tctx.tokenizers.register(m, MockTokenizer(), default=i == 0)
        tctx.registry.add(Worker(worker_id=f"w{i}", client=InProcWorkerClient(te),
                                 model_id=m, page_size=16))
    try:
        want = asyncio.run(_chats(jserver, jctx, bodies))
        got = asyncio.run(_chats(tserver, tctx, bodies))
    finally:
        je.stop()
        te.stop()
    statuses = {m: s for m, (s, _) in zip(models, got)}
    assert statuses == {m: s for m, (s, _) in zip(models, want)}
    for (gs, gb), (ws, wb) in zip(got, want):
        assert _strip(gb) == _strip(wb)
    # the families whose placeholders are the merging tower's rows answer;
    # one token a patch (LLaVA, Pixtral, Llama 4) or Phi-4's separators do not
    bad = {FAMILY_MODELS[f] for f in ("llava", "pixtral", "llama4", "phi4_v")}
    assert statuses == {m: 502 if m in bad else 200 for m in models}
    for m, (s, body) in zip(models, got):
        if s == 502:
            assert "embeddings for" in body["error"]["message"]
            assert "placeholder tokens" in body["error"]["message"]
        else:
            assert body["usage"]["prompt_tokens"] > 4
