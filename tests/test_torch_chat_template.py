"""The port's chat template and the agent's image intake against the
reference's, on the CPU. Both render with ``jinja2`` and decode with PIL
(both are on the card's machine: PyTorch requires ``jinja2``), so the
outputs must be equal exactly:

- ``JinjaChatTemplate.apply`` over the default ChatML template and a
  Qwen2-VL-Instruct-shaped one (a system turn added, ``loop.first``,
  ``is string``, ``namespace`` counters), with strings, multimodal parts,
  tools and extra kwargs;
- ``_build_mm_token_ids``: the rendered markers expanded to ``out_tokens``
  placeholder ids, with the byte tokenizer;
- ``_extract_images``: PNG data URIs (RGB, RGBA, gray; sizes that resize
  up and down) and raw ``image_data`` parts, bit for bit, and the same
  ValueError for a URL that is not a data URI and an unknown image part.
"""

import base64
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest

from xllm_service_tpu import chat_template as ref_ct
from xllm_service_tpu.engine.agent import EngineAgent as RefAgent
from xllm_service_tpu.models import qwen2_vl as ref_vl
from xllm_service_tpu.tokenizer.simple import SimpleTokenizer as RefTok
from xllm_service_tpu_torch import chat_template as ct
from xllm_service_tpu_torch.engine.agent import EngineAgent
from xllm_service_tpu_torch.tokenizer.simple import SimpleTokenizer

from test_torch_qwen2_vl import port_config

QWEN2_VL_STYLE = (
    "{% set image_count = namespace(value=0) %}"
    "{% for message in messages %}"
    "{% if loop.first and message['role'] != 'system' %}"
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    "{% endif %}"
    "<|im_start|>{{ message['role'] }}\n"
    "{% if message['content'] is string %}{{ message['content'] }}<|im_end|>\n"
    "{% else %}{% for content in message['content'] %}"
    "{% if 'text' in content %}{{ content['text'] }}{% endif %}"
    "{% set image_count.value = image_count.value + 1 %}"
    "{% endfor %}<|im_end|>\n{% endif %}"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")

MESSAGES = [
    [{"role": "user", "content": "hello"}],
    [{"role": "system", "content": "be brief"},
     {"role": "user", "content": [
         {"type": "text", "text": "what is "},
         {"type": "image_url", "image_url": {"url": "data:,"}},
         {"type": "text", "text": " and "},
         {"type": "image_data", "data": "", "shape": [1]}]},
     {"role": "assistant", "content": "a cat"},
     {"role": "user", "content": None}],
    [{"role": "user", "content": ["bare", {"type": "text", "text": "x"}]}],
]


def test_constants_are_the_references():
    assert ct.DEFAULT_CHAT_TEMPLATE == ref_ct.DEFAULT_CHAT_TEMPLATE
    assert ct.MM_PLACEHOLDER == ref_ct.MM_PLACEHOLDER


@pytest.mark.parametrize("template", [None, QWEN2_VL_STYLE],
                         ids=["chatml", "qwen2_vl"])
@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_apply_renders_as_the_reference(template, i):
    kw = dict(tools=[{"type": "function", "name": "f"}],
              chat_template_kwargs={"add_vision_id": True})
    for gen in (True, False):
        want = ref_ct.JinjaChatTemplate(template).apply(
            MESSAGES[i], add_generation_prompt=gen, **kw)
        got = ct.JinjaChatTemplate(template).apply(
            MESSAGES[i], add_generation_prompt=gen, **kw)
        assert got == want


def test_raise_exception_in_a_template():
    tmpl = "{{ raise_exception('no tools') }}"
    import jinja2

    with pytest.raises(jinja2.TemplateError, match="no tools"):
        ct.JinjaChatTemplate(tmpl).apply(MESSAGES[0])


def _stand_ins(template=None):
    """(reference agent, port agent) stand-ins with what the two methods
    read: the engine's model config and tokenizer, the chat template."""
    rcfg = ref_vl.tiny_vl_config(dtype=jnp.float32, image_token_id=100,
                                 vision=ref_vl.tiny_vl_config().vision)
    ref = types.SimpleNamespace(
        engine=types.SimpleNamespace(cfg=types.SimpleNamespace(model=rcfg),
                                     tokenizer=RefTok()),
        chat_template=ref_ct.JinjaChatTemplate(template),
        _is_image_part=RefAgent._is_image_part)
    port = types.SimpleNamespace(
        engine=types.SimpleNamespace(
            cfg=types.SimpleNamespace(model=port_config(rcfg)),
            tokenizer=SimpleTokenizer()),
        chat_template=ct.JinjaChatTemplate(template),
        _is_image_part=EngineAgent._is_image_part)
    return ref, port


@pytest.mark.parametrize("template", [None, QWEN2_VL_STYLE],
                         ids=["chatml", "qwen2_vl"])
def test_build_mm_token_ids_is_the_references(template):
    ref, port = _stand_ins(template)
    for msgs in MESSAGES:
        want = RefAgent._build_mm_token_ids(ref, msgs)
        got = EngineAgent._build_mm_token_ids(port, msgs)
        assert got == want
    ids = EngineAgent._build_mm_token_ids(port, MESSAGES[1])
    assert ids.count(100) == 2 * 4          # two images, out_tokens 4


def _png(seed, size, mode):
    from PIL import Image

    rng = np.random.default_rng(seed)
    ch = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = rng.integers(0, 256, (size[1], size[0], ch), dtype=np.uint8)
    img = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def test_extract_images_is_the_references():
    raw = np.random.default_rng(9).uniform(size=(28, 28, 3)).astype(
        np.float32)
    msgs = [{"role": "user", "content": "no images here"},
            {"role": "user", "content": [
                {"type": "text", "text": "look"},
                {"type": "image_url", "image_url": {
                    "url": _png(1, (28, 28), "RGB")}},
                {"type": "image_url", "image_url": {
                    "url": _png(2, (50, 31), "RGBA")}},
                {"type": "image_url", "image_url": {
                    "url": _png(3, (13, 17), "L")}},
                {"type": "image_data",
                 "data": base64.b64encode(raw.tobytes()).decode(),
                 "shape": [28, 28, 3]}]}]
    ref, port = _stand_ins()
    want = RefAgent._extract_images(ref, msgs)
    got = EngineAgent._extract_images(port, msgs)
    assert got.shape == (4, 28, 28, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert EngineAgent._extract_images(port, msgs[:1]) is None


@pytest.mark.parametrize("part,match", [
    ({"type": "image_url", "image_url": {"url": "https://x/cat.png"}},
     "data: URIs"),
    ({"type": "image_file", "file_id": "f1"}, "unsupported image part"),
])
def test_extract_images_refuses_as_the_reference(part, match):
    msgs = [{"role": "user", "content": [part]}]
    ref, port = _stand_ins()
    for cls, obj in ((RefAgent, ref), (EngineAgent, port)):
        with pytest.raises(ValueError, match=match):
            cls._extract_images(obj, msgs)
