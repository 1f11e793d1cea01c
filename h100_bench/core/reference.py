"""The plain reference: Whisper as published (``WhisperForConditionalGeneration``:
pre-LayerNorm blocks, exact GELU, no key bias, tied vocabulary projection),
its log-mel frontend, the bias-word trie of greedy decoding, the
bias-weighted cross-entropy and AdamW, in plain torch and numpy.

It imports nothing of the program and takes only what the benchmark made:
the weights under their HF names and the raw inputs. It computes in
float32 with TF32 off. ``lowp="fp8"`` computes every product on operands
rounded to float8 e4m3 with one scale a tensor (the control: the precision
below the configuration's bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, N_SAMPLES = 400, 160, 480000


def precise() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# log-mel: 400-point Hann STFT, hop 160, Slaney mel filterbank, log10 tail
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) * 27.0 / np.log(6.4),
                    3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)


def mel_filters(n_mels: int) -> np.ndarray:
    """(n_mels, 201) Slaney-normalised triangles from 0 to 8 kHz."""
    freqs = np.linspace(0.0, 8000.0, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0), n_mels + 2))
    diff = np.diff(hz)
    slopes = hz[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:])).T
    return fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, 480000) samples -> (B, n_mels, 3000) f32 features, in float64."""
    x = audio.to(torch.float64)
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=win, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.abs() ** 2
    fb = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    log = torch.log10(torch.clamp(fb @ power, min=1e-10))
    log = torch.maximum(log, log.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((log + 4.0) / 4.0).float()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class _Fp8(torch.autograd.Function):
    """Rounds to float8 e4m3 with one scale for the tensor; the gradient
    passes straight through, and nothing is saved for the backward."""

    @staticmethod
    def forward(ctx, x):
        s = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


class Reference:
    """Whisper from HF-named tensors ``w`` (any float type; used as f32)."""

    def __init__(self, w: dict, g: dict, lowp: str | None = None, grad: bool = False):
        self.g = g
        self.w = {k: v.detach().float().clone().requires_grad_(grad) for k, v in w.items()}
        self.q = fp8 if lowp == "fp8" else (lambda x: x)

    def lin(self, x, name, bias=True):
        y = self.q(x) @ self.q(self.w[f"{name}.weight"]).t()
        return y + self.w[f"{name}.bias"] if bias else y

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            1e-5)

    def attend(self, x, kv, name, causal: bool):
        h = self.g["heads"]
        b, s, d = x.shape
        t = kv.shape[1]
        q = self.lin(x, f"{name}.q_proj").view(b, s, h, -1).transpose(1, 2)
        k = self.lin(kv, f"{name}.k_proj", bias=False).view(b, t, h, -1).transpose(1, 2)
        v = self.lin(kv, f"{name}.v_proj").view(b, t, h, -1).transpose(1, 2)
        scores = (self.q(q) @ self.q(k).transpose(-1, -2)) / math.sqrt(d // h)
        if causal:
            keep = torch.ones(s, t, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~keep, float("-inf"))
        out = self.q(torch.softmax(scores, dim=-1)) @ self.q(v)
        return self.lin(out.transpose(1, 2).reshape(b, s, d), f"{name}.out_proj")

    def mlp(self, x, p):
        return self.lin(F.gelu(self.lin(x, f"{p}.fc1")), f"{p}.fc2")

    def conv(self, x, name, stride):
        return F.conv1d(self.q(x), self.q(self.w[f"{name}.weight"]), self.w[f"{name}.bias"],
                        stride=stride, padding=1)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) -> (B, 1500, d)."""
        x = F.gelu(self.conv(mel, "model.encoder.conv1", 1))
        x = F.gelu(self.conv(x, "model.encoder.conv2", 2)).transpose(1, 2)
        x = x + self.w["model.encoder.embed_positions.weight"]
        for i in range(self.g["enc_layers"]):
            p = f"model.encoder.layers.{i}"
            a = self.ln(x, f"{p}.self_attn_layer_norm")
            x = x + self.attend(a, a, f"{p}.self_attn", causal=False)
            x = x + self.mlp(self.ln(x, f"{p}.final_layer_norm"), p)
        return self.ln(x, "model.encoder.layer_norm")

    def logits(self, ids: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder: ids (B, S) at positions 0..S-1 -> f32
        logits (B, S, V)."""
        s = ids.shape[1]
        emb = self.w["model.decoder.embed_tokens.weight"]
        x = emb[ids] + self.w["model.decoder.embed_positions.weight"][:s]
        for i in range(self.g["dec_layers"]):
            p = f"model.decoder.layers.{i}"
            a = self.ln(x, f"{p}.self_attn_layer_norm")
            x = x + self.attend(a, a, f"{p}.self_attn", causal=True)
            x = x + self.attend(self.ln(x, f"{p}.encoder_attn_layer_norm"), enc,
                                f"{p}.encoder_attn", causal=False)
            x = x + self.mlp(self.ln(x, f"{p}.final_layer_norm"), p)
        x = self.ln(x, "model.decoder.layer_norm")
        return self.q(x) @ self.q(emb).t()


# ---------------------------------------------------------------------------
# the bias-word trie of greedy decoding (shallow fusion)
# ---------------------------------------------------------------------------

class Trie:
    """Each bias word's matched length: a token that extends a word in
    progress moves it on, a word's first token (re)starts it, anything else
    resets it; a completed word starts over. The next token of every word
    in progress gets ``boost`` (once, however many words share it)."""

    def __init__(self, words: list[list[int]]):
        self.words = [list(w) for w in words if w]
        self.m = [0] * len(self.words)

    def advance(self, tok: int) -> None:
        for n, w in enumerate(self.words):
            ext = self.m[n] + 1 if w[self.m[n]] == tok else 0
            new = max(ext, 1 if w[0] == tok else 0)
            self.m[n] = 0 if new >= len(w) else new

    def boosted(self) -> set[int]:
        return {w[self.m[n]] for n, w in enumerate(self.words)}


def served_gaps(ref_lg: torch.Tensor, served: list[int], prefix: list[int],
                words: list[list[int]], boost: float,
                pick_lg: torch.Tensor | None = None) -> np.ndarray:
    """The gap by which each served token's biased reference logit lies
    below the best one: ``ref_lg`` (n, V) are the reference's logits at the
    positions that chose ``served`` (n tokens). With ``pick_lg`` the token
    judged at each position is the one ``pick_lg`` puts first (a control),
    not the served one."""
    trie = Trie(words)
    for tok in prefix:
        trie.advance(tok)
    lg = ref_lg.double().clone()
    pick = None if pick_lg is None else pick_lg.double().clone()
    for t, tok in enumerate(served):
        idx = torch.tensor(sorted(trie.boosted()), dtype=torch.long, device=lg.device)
        if len(idx):
            lg[t, idx] += boost
            if pick is not None:
                pick[t, idx] += boost
        trie.advance(tok)
    chosen = (torch.tensor(served, device=lg.device) if pick is None else pick.argmax(dim=-1))
    gaps = lg.max(dim=-1).values - lg.gather(1, chosen[:, None])[:, 0]
    return gaps.cpu().numpy()


# ---------------------------------------------------------------------------
# WeightCE fine-tuning
# ---------------------------------------------------------------------------

IGNORE = -100


def collate_labels(labels: list[list[int]], sot: int, pad: int) -> tuple[np.ndarray, np.ndarray]:
    """Teacher forcing over full label sequences: decoder inputs (rows
    without their last token, padded with ``pad``) and targets (rows without
    their first, padded and masked with IGNORE, the prompt before the first
    ``sot`` masked too)."""
    s = max(len(x) for x in labels) - 1
    inp = np.full((len(labels), s), pad, np.int64)
    tgt = np.full((len(labels), s), IGNORE, np.int64)
    for i, x in enumerate(labels):
        inp[i, :len(x) - 1] = x[:-1]
        y = np.asarray(x[1:], np.int64)
        first = int(np.argmax(y == sot)) if (y == sot).any() else 0
        y[:first] = IGNORE
        tgt[i, :len(y)] = y
    return inp, tgt


def span_weights(target: np.ndarray, spans: list[list[int]], weight: float,
                 special_from: int) -> np.ndarray:
    """``weight`` on every target position covered by a whole occurrence of
    a bias span, 1 elsewhere; special tokens and ignored positions keep 1."""
    w = np.ones(len(target), np.float32)
    for sp in spans:
        n = len(sp)
        for j in range(len(target) - n + 1):
            if list(target[j:j + n]) == list(sp):
                w[j:j + n] = weight
    w[(target >= special_from) | (target < 0)] = 1.0
    return w


class AdamW:
    """Clip to a global norm (only when the norm reaches it), then AdamW with
    bias-corrected moments, eps outside the root and decoupled weight decay
    on every tensor."""

    def __init__(self, params: dict, lr, betas, eps, weight_decay, max_norm):
        self.p = params
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.wd, self.max_norm = weight_decay, max_norm
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Applies one update; returns the clipped gradients it used."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = self.max_norm / norm if norm >= self.max_norm else 1.0
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        clipped = {}
        for k, p in self.p.items():
            g = grads[k] * scale
            clipped[k] = g
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + self.eps) + self.wd * p
            p.add_(-self.lr * u)
        return clipped
