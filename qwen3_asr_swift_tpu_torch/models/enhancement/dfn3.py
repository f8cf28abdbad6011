"""DeepFilterNet3 network — port of
``qwen3_asr_swift_tpu/models/enhancement/dfn3.py``.

The published topology (encoder with separable-conv ERB and complex-spec
pathways, SqueezedGRU_S embedding, U-Net ERB mask decoder, grouped-linear
deep-filter decoder) as functions on tensors, with the reference's
parameter tree (torch OIHW conv weights, GRU weights in torch gate order
``r, z, n``):

- every conv is a matmul over strided windows (``unfold`` + ``einsum``),
  so fp32 runs in full fp32 on the card as on the host (cuDNN's fp32 convs
  default to TF32) without a process-wide flag; the transposed convs
  dilate their input along frequency and convolve, as the reference's
  lhs-dilated form does;
- the GRUs take every step's input product at once and loop over time for
  the recurrence;
- the 2-frame lookahead is the reference's global feature shift at net
  entry, and every time-dependent piece (conv input histories, GRU
  hiddens) is carried in :class:`DfnState`, so chunked inference equals
  the batch pass.

``init_dfn3_params`` draws the weights with numpy from a generator.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import _normal

# Hyperparameters — reference Configuration.swift:53-73.
NB_ERB = 32
NB_DF = 96
DF_ORDER = 5
CONV_CH = 64
EMB_HIDDEN = 256
EMB_DIM = CONV_CH * NB_ERB // 4  # 512 (encoder embedding / GRU in-out width)
DF_HIDDEN = 256
ENC_LIN_GROUPS = 32
LIN_GROUPS = 16
LOOKAHEAD = 2
DF_PATHWAY_KT = 5
LSNR_MIN = -15.0
LSNR_MAX = 35.0


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

def _conv_nchw(x: torch.Tensor, w: torch.Tensor, fstride: int = 1, fpad=(0, 0),
               groups: int = 1) -> torch.Tensor:
    """Valid-in-time NCHW conv (``x`` already padded in time) with OIHW
    ``w``, frequency stride ``fstride`` and padding ``fpad``, as a matmul
    over the windows."""
    b, c, _, _ = x.shape
    o, cg, kt, kf = w.shape
    if fpad != (0, 0):
        x = F.pad(x, (fpad[0], fpad[1]))
    win = x.unfold(2, kt, 1).unfold(3, kf, fstride)          # [B, C, T', F', kt, kf]
    tn, fn = win.shape[2], win.shape[3]
    win = win.reshape(b, groups, cg, tn, fn, kt, kf)
    wg = w.to(x.dtype).reshape(groups, o // groups, cg, kt, kf)
    y = torch.einsum("bgitfkl,goikl->bgotf", win, wg)
    return y.reshape(b, o, tn, fn)


def _bn(x: torch.Tensor, p) -> torch.Tensor:
    """Inference-mode BatchNorm2d over the channel axis of NCHW."""
    inv = torch.rsqrt(p["var"] + 1e-5)
    return (x - p["mean"][None, :, None, None]) * (inv * p["scale"])[None, :, None, None] \
        + p["bias"][None, :, None, None]


def _post(y, p):
    if "b" in p:
        y = y + p["b"][None, :, None, None]
    if "pw" in p:
        y = _conv_nchw(y, p["pw"])
    if "bn" in p:
        y = _bn(y, p["bn"])
    return y


def conv_norm_act(x, p, *, kernel_t: int, fstride: int = 1, act: str = "relu", hist=None):
    """Conv2dNormAct: causal time pad → conv (+ 1x1 pointwise when
    separable) → BatchNorm → activation. ``hist`` [1,C,kernel_t-1,F]
    replaces the leading zero pad for streaming; returns (y, new_hist). The
    group count comes from the weight's shape, as in the reference."""
    kt = kernel_t
    new_hist = None
    if kt > 1:
        if hist is None:
            hist = x.new_zeros(x.shape[:2] + (kt - 1, x.shape[3]))
        x = torch.cat([hist, x], dim=2)
        new_hist = x[:, :, -(kt - 1):, :]
    kf = p["w"].shape[-1]
    groups = x.shape[1] // p["w"].shape[1]
    y = _post(_conv_nchw(x, p["w"], fstride, (kf // 2, kf // 2), groups), p)
    if act == "relu":
        y = torch.relu(y)
    elif act == "sigmoid":
        y = torch.sigmoid(y)
    return y, new_hist


def conv_transpose_norm_act(x, p, *, fstride: int = 2):
    """ConvTranspose2dNormAct over frequency (torch kernel (1,3), stride
    (1,fstride), padding (0,1), output_padding (0,fstride-1)): the input
    dilated by ``fstride`` along frequency, padded (kf-2, kf-2+fstride-1)
    and convolved with ``p["w"]`` (OIHW, taps flipped by convert.py)."""
    kf = p["w"].shape[-1]
    groups = x.shape[1] // p["w"].shape[1]
    b, c, t, f = x.shape
    xd = x.new_zeros((b, c, t, (f - 1) * fstride + 1))
    xd[..., ::fstride] = x
    y = _conv_nchw(xd, p["w"], 1, (kf - 2, kf - 2 + fstride - 1), groups)
    return torch.relu(_post(y, p))


def grouped_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """GroupedLinearEinsum: x [T, in], w [groups, in/groups, out/groups]."""
    t = x.shape[0]
    g = w.shape[0]
    return torch.einsum("tgi,gih->tgh", x.reshape(t, g, -1), w).reshape(t, -1)


def _gru_layer(x, p, h0):
    """Torch nn.GRU single layer over [T, D], gate order (r, z, n): the
    input products of every step at once, the recurrence a loop."""
    hid = p["wh"].shape[1]
    gi = x @ p["wi"].T + p["bi"]                             # [T, 3H]
    wh_t = p["wh"].T
    h = x.new_zeros((hid,)) if h0 is None else h0
    ys = x.new_empty((x.shape[0], hid))
    for t in range(x.shape[0]):
        gh = h @ wh_t + p["bh"]
        r = torch.sigmoid(gi[t, :hid] + gh[:hid])
        z = torch.sigmoid(gi[t, hid:2 * hid] + gh[hid:2 * hid])
        n = torch.tanh(gi[t, 2 * hid:] + r * gh[2 * hid:])
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return ys, h


def squeezed_gru(x, p, hs=None):
    """SqueezedGRU_S: grouped linear-in (+ReLU) → n-layer GRU → optional
    grouped linear-out (+ReLU). ``hs`` is a tuple of per-layer hiddens."""
    y = torch.relu(grouped_linear(x, p["lin_in"]))
    n_layers = len(p["gru"])
    if hs is None:
        hs = (None,) * n_layers
    new_hs = []
    for i, layer in enumerate(p["gru"]):
        y, h_t = _gru_layer(y, layer, hs[i])
        new_hs.append(h_t)
    if "lin_out" in p:
        y = torch.relu(grouped_linear(y, p["lin_out"]))
    return y, tuple(new_hs)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

class DfnState(NamedTuple):
    """Carried network state for streaming (conv histories + GRU hiddens)."""
    erb_conv0_hist: torch.Tensor   # [1,1,2,32] past net-input ERB frames
    df_conv0_hist: torch.Tensor    # [1,2,2,96] past net-input spec frames
    df_convp_hist: torch.Tensor    # [1,64,4,96] past c0 frames
    enc_gru: tuple                 # 1 × [256]
    erb_gru: tuple                 # 2 × [256]
    df_gru: tuple                  # 2 × [256]


def init_state(device, dtype=torch.float32) -> DfnState:
    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    return DfnState(
        erb_conv0_hist=z(1, 1, 2, NB_ERB),
        df_conv0_hist=z(1, 2, 2, NB_DF),
        df_convp_hist=z(1, CONV_CH, DF_PATHWAY_KT - 1, NB_DF),
        enc_gru=(z(EMB_HIDDEN),),
        erb_gru=(z(EMB_HIDDEN), z(EMB_HIDDEN)),
        df_gru=(z(DF_HIDDEN), z(DF_HIDDEN)),
    )


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def dfn3_step(params, feat_erb, feat_spec, state: DfnState):
    """One streaming step over already-lookahead-shifted net inputs.

    feat_erb: [F, 32] normalized dB ERB features (net-input timeline)
    feat_spec: [F, 96, 2] unit-normalized complex low-band spectrum
    Returns (erb_mask [F,32], df_coefs [F,96,5,2], lsnr [F], new_state).
    """
    enc, erb_dec, df_dec = params["enc"], params["erb_dec"], params["df_dec"]
    t = feat_erb.shape[0]

    xe = feat_erb[None, None]                              # [1,1,T,32]
    xs = torch.movedim(feat_spec, -1, 0)[None]             # [1,2,T,96]

    e0, h_e = conv_norm_act(xe, enc["erb_conv0"], kernel_t=3, hist=state.erb_conv0_hist)
    e1, _ = conv_norm_act(e0, enc["erb_conv1"], kernel_t=1, fstride=2)
    e2, _ = conv_norm_act(e1, enc["erb_conv2"], kernel_t=1, fstride=2)
    e3, _ = conv_norm_act(e2, enc["erb_conv3"], kernel_t=1, fstride=1)

    c0, h_s = conv_norm_act(xs, enc["df_conv0"], kernel_t=3, hist=state.df_conv0_hist)
    c1, _ = conv_norm_act(c0, enc["df_conv1"], kernel_t=1, fstride=2)

    # [1,C,T,F] → [T, F*C] (freq-major flatten, torch permute(0,2,3,1).flatten(2))
    cemb = c1[0].permute(1, 2, 0).reshape(t, -1)
    cemb = torch.relu(grouped_linear(cemb, enc["df_fc_emb"]))
    emb = e3[0].permute(1, 2, 0).reshape(t, -1)
    emb, h_enc = squeezed_gru(emb + cemb, enc["emb_gru"], state.enc_gru)
    lsnr = torch.sigmoid(emb @ enc["lsnr"]["w"].T + enc["lsnr"]["b"])[:, 0]
    lsnr = lsnr * (LSNR_MAX - LSNR_MIN) + LSNR_MIN

    # --- ERB mask decoder (U-Net skips off e0..e3) ---
    embd, h_erb = squeezed_gru(emb, erb_dec["emb_gru"], state.erb_gru)
    embc = embd.reshape(t, NB_ERB // 4, CONV_CH).permute(2, 0, 1)[None]
    t3, _ = conv_norm_act(e3, erb_dec["conv3p"], kernel_t=1)
    d3, _ = conv_norm_act(t3 + embc, erb_dec["convt3"], kernel_t=1)
    t2, _ = conv_norm_act(e2, erb_dec["conv2p"], kernel_t=1)
    d2 = conv_transpose_norm_act(t2 + d3, erb_dec["convt2"], fstride=2)
    t1, _ = conv_norm_act(e1, erb_dec["conv1p"], kernel_t=1)
    d1 = conv_transpose_norm_act(t1 + d2, erb_dec["convt1"], fstride=2)
    t0, _ = conv_norm_act(e0, erb_dec["conv0p"], kernel_t=1)
    m, _ = conv_norm_act(t0 + d1, erb_dec["conv0_out"], kernel_t=1, act="sigmoid")
    erb_mask = m[0, 0]                                     # [T, 32]

    # --- deep-filter decoder ---
    c, h_df = squeezed_gru(emb, df_dec["df_gru"], state.df_gru)
    cp, h_p = conv_norm_act(c0, df_dec["df_convp"], kernel_t=DF_PATHWAY_KT,
                            hist=state.df_convp_hist)
    cp = cp[0].permute(1, 2, 0)                            # [T, 96, 10]
    cdf = torch.tanh(grouped_linear(c, df_dec["df_out"]))
    coefs = (cdf.reshape(t, NB_DF, DF_ORDER * 2) + cp).reshape(t, NB_DF, DF_ORDER, 2)

    new_state = DfnState(erb_conv0_hist=h_e, df_conv0_hist=h_s, df_convp_hist=h_p,
                         enc_gru=h_enc, erb_gru=h_erb, df_gru=h_df)
    return erb_mask, coefs, lsnr, new_state


def dfn3_forward(params, feat_erb, feat_spec):
    """Batch forward with the 2-frame lookahead shift (trim the first
    ``LOOKAHEAD`` frames, append zeros); the trimmed leading frames seed
    the input-conv histories, so output frame 0 sees features 0..2."""
    t = feat_erb.shape[0]

    def shifted(x):
        pad = x.new_zeros((LOOKAHEAD,) + tuple(x.shape[1:]))
        return torch.cat([x[LOOKAHEAD:], pad])[:t], torch.cat([x[:LOOKAHEAD], pad])[:LOOKAHEAD]

    shift_erb, lead_erb = shifted(feat_erb)
    shift_spec, lead_spec = shifted(feat_spec)
    state = init_state(feat_erb.device, feat_erb.dtype)._replace(
        erb_conv0_hist=lead_erb[None, None],                       # [1,1,2,32]
        df_conv0_hist=torch.movedim(lead_spec, -1, 0)[None])       # [1,2,2,96]
    mask, coefs, lsnr, _ = dfn3_step(params, shift_erb, shift_spec, state)
    return mask, coefs, lsnr


# ---------------------------------------------------------------------------
# random init (numpy, from a generator): the reference's tree and scales
# ---------------------------------------------------------------------------

def init_dfn3_params(rng: np.random.Generator) -> dict:
    def normal(*shape):
        return _normal(rng, shape, 1.0)

    def conv(o, i, kt, kf, bias=False, pw=True, bn=True):
        p = {"w": normal(o, i, kt, kf) * np.float32(0.25 / np.sqrt(i * kt * kf))}
        if bias:
            p["b"] = np.zeros((o,), np.float32)
        if pw:
            p["pw"] = normal(o, o, 1, 1) / np.float32(np.sqrt(o))
        if bn:
            p["bn"] = {"scale": np.ones((o,), np.float32), "bias": np.zeros((o,), np.float32),
                       "mean": np.zeros((o,), np.float32), "var": np.ones((o,), np.float32)}
        return p

    def glin(i, o, g):
        return normal(g, i // g, o // g) / np.float32(np.sqrt(i // g))

    def gru(i, h):
        return {"wi": normal(3 * h, i) / np.float32(np.sqrt(i)),
                "wh": normal(3 * h, h) / np.float32(np.sqrt(h)),
                "bi": np.zeros((3 * h,), np.float32), "bh": np.zeros((3 * h,), np.float32)}

    def sgru(i, h, o, layers):
        p = {"lin_in": glin(i, h, LIN_GROUPS), "gru": tuple(gru(h, h) for _ in range(layers))}
        if o is not None:
            p["lin_out"] = glin(h, o, LIN_GROUPS)
        return p

    c = CONV_CH
    return {
        "enc": {
            "erb_conv0": conv(c, 1, 3, 3, pw=False),
            "erb_conv1": conv(c, 1, 1, 3),
            "erb_conv2": conv(c, 1, 1, 3),
            "erb_conv3": conv(c, 1, 1, 3),
            "df_conv0": conv(c, 1, 3, 3),
            "df_conv1": conv(c, 1, 1, 3),
            "df_fc_emb": glin(c * NB_DF // 2, EMB_DIM, ENC_LIN_GROUPS),
            "emb_gru": sgru(EMB_DIM, EMB_HIDDEN, EMB_DIM, 1),
            "lsnr": {"w": normal(1, EMB_DIM) / np.float32(np.sqrt(EMB_DIM)),
                     "b": np.zeros((1,), np.float32)},
        },
        "erb_dec": {
            "emb_gru": sgru(EMB_DIM, EMB_HIDDEN, EMB_DIM, 2),
            "conv3p": conv(c, c, 1, 1, pw=False),
            "convt3": conv(c, 1, 1, 3),
            "conv2p": conv(c, c, 1, 1, pw=False),
            "convt2": conv(c, 1, 1, 3),
            "conv1p": conv(c, c, 1, 1, pw=False),
            "convt1": conv(c, 1, 1, 3),
            "conv0p": conv(c, c, 1, 1, pw=False),
            "conv0_out": conv(1, c, 1, 3, bias=True, pw=False, bn=False),
        },
        "df_dec": {
            "df_gru": sgru(EMB_DIM, DF_HIDDEN, None, 2),
            "df_out": glin(DF_HIDDEN, NB_DF * DF_ORDER * 2, LIN_GROUPS),
            "df_convp": conv(DF_ORDER * 2, c // 2, DF_PATHWAY_KT, 1),
        },
    }
