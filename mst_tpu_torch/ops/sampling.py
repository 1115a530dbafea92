"""Probability-map sampling (counterpart of mst_tpu/ops/sampling.py:48-105;
reference utils/image_utils.py:110-135).

With replacement: inverse-CDF sampling, one cumsum and
torch.searchsorted(right=True), which skips zero-weight bins even on exact
ties. Without replacement: Gumbel top-k, the exact sequential-multinomial
distribution. The noise comes from a torch.Generator, or is passed in
(`u=`, `gumbel=`) so a test can feed both packages the same draws, or
comes from a `Draws` in place of the generator: noise drawn ahead, as a
CUDA graph's replay (train/fused.py) and the grid's vmapped runs need it,
or from a `Key`: every draw a function of an int64 key tensor, in integer
tensor ops a traced program (torch.export) carries with the key as its
input, and the same bits on the CPU and on the card. A `Rows` draws a
block of a global batch's rows from any of them, as a world of one draws
them (a rank of a data-parallel mesh).
"""

import torch

_MASK32 = 0xFFFFFFFF
# odd multipliers below 2^31: a product with a 32-bit word stays below
# 2^63, so no int64 product wraps
_MULTIPLIERS = (0x7FEB352D, 0x2C1B3C6D, 0x297A2D39)


def mix32(h):
    """A bijection of 32-bit words held in int64 (xor-shift-multiply
    rounds)."""
    h = h ^ (h >> 16)
    for m, shift in zip(_MULTIPLIERS, (15, 13, 16)):
        h = (h * m) & _MASK32
        h = h ^ (h >> shift)
    return h


def key_from_generator(generator=None, device=None):
    """A key (int64 (2,) of 32-bit words): the first two draws of
    `generator` (the global one if None), on `device` (the generator's if
    None)."""
    gen_device = generator.device if generator is not None else "cpu"
    key = torch.randint(0, 1 << 32, (2,), generator=generator,
                        device=gen_device)
    return key.to(device if device is not None else gen_device)


def key_from_seed(seed, device=None):
    """The key of a seed: the first two draws of
    torch.Generator().manual_seed(seed) on the CPU, whatever `device`
    the key is put on."""
    return key_from_generator(torch.Generator().manual_seed(int(seed)),
                              device or "cpu")


class Key:
    """Draws from a key: `key`, int64 (2,) holding two 32-bit words. A
    draw is a counter-based hash of (key, stream, counter, element index):
    each draw call takes the next stream number (fixed when a program is
    traced), `counter` separates the draws of a loop's iterations (an
    int, or an int64 tensor of counters), and within one (stream,
    counter) the map from element index to bits is a bijection of 32-bit
    words. Only
    integer tensor ops, so a key gives the same bits on the CPU and on
    the card."""

    def __init__(self, key):
        self.key = key
        self.streams = 0

    def stream(self):
        """The next stream number."""
        s = self.streams
        self.streams += 1
        return s

    def bits(self, shape, stream=None, counter=0):
        """int64 of `shape` holding uniform 32-bit words; with a tensor of
        counters, one such draw for each, stacked in front (a counter's
        draw the same as alone)."""
        if stream is None:
            stream = self.stream()
        k = self.key
        h = mix32(mix32(mix32(mix32(k[0]) ^ k[1]) ^ stream) ^ counter)
        n = 1
        for d in shape:
            n *= d
        idx = torch.arange(n, dtype=torch.int64, device=k.device)
        return mix32(h.reshape(*h.shape, 1) ^ idx).reshape(*h.shape, *shape)

    def uniform(self, shape):
        """f32 in [0, 1): a 24-bit integer times 2^-24."""
        return (self.bits(shape) >> 8).to(torch.float32) * 2.0 ** -24

    def randint(self, high, shape, stream=None, counter=0):
        """int64 in [0, high): floor(high * u) of the 24-bit uniform u;
        high below 2^39. `counter` as in bits."""
        return ((self.bits(shape, stream, counter) >> 8) * high) >> 24

    def exponential(self, like):
        """Standard exponential noise of like's shape and dtype
        (exponential_of_24_bits)."""
        return exponential_of_24_bits(self.bits(tuple(like.shape)) >> 8).to(
            like.dtype)


def exponential_of_24_bits(m):
    """int64 m in [0, 2^24) -> f32 -log(u), u = (m + 1) 2^-24 in (0, 1],
    taken in f64 and rounded once to f32, so that the CPU and the card
    agree; u = 1 gives 2^-25 in place of 0, as torch's CUDA exponential_
    keeps its draws above 0 (a Gumbel draw -log(E) stays finite)."""
    u = (m + 1).to(torch.float64) * 2.0 ** -24
    return (-torch.log(u)).to(torch.float32).clamp(min=2.0 ** -25)


class Draws:
    """The exponential draws of the samplers without replacement, made
    ahead: given `tensors`, each draw takes the next one (of the shape the
    generator would have filled); given a `generator`, each draw comes
    from it and is kept in `drawn`, so the same shapes can be drawn ahead
    from the same seeds, bit for bit (the same kernel fills the same
    shape)."""

    def __init__(self, tensors=None, generator=None):
        self.tensors = None if tensors is None else list(tensors)
        self.generator = generator
        self.drawn = []

    def exponential(self, like):
        if self.tensors is None:
            t = torch.empty_like(like).exponential_(generator=self.generator)
            self.drawn.append(t)
            return t
        t = self.tensors[len(self.drawn)]
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"drawn noise of shape {tuple(t.shape)} where "
                             f"the sampler draws {tuple(like.shape)}")
        self.drawn.append(t)
        return t


class Rows:
    """The draws of rows [lo, hi) of a global batch of n rows from
    `source` (a torch.Generator, Draws or Key), bit for bit as a world of
    one draws them: each draw is made at the global batch's shape, the
    batch on axis batch_dim, and narrowed to these rows. So each row of a
    rank of a data-parallel mesh (parallel/mesh.py) draws what the same
    row draws in one process; a rank draws the whole batch's noise."""

    def __init__(self, source, lo, hi, n):
        self.source, self.lo, self.hi, self.n = source, lo, hi, n

    def _global(self, shape, batch_dim):
        shape = list(shape)
        shape[batch_dim] = self.n
        return shape

    def _narrow(self, t, batch_dim):
        return t.narrow(batch_dim, self.lo, self.hi - self.lo)

    def exponential(self, like, batch_dim=0):
        t = exponential(like.new_empty(self._global(like.shape, batch_dim)),
                        self.source)
        return self._narrow(t, batch_dim)

    def uniform(self, shape, device, batch_dim=0):
        return self._narrow(uniform(self._global(shape, batch_dim), device,
                                    self.source), batch_dim)

    def keyed(self, device):
        """The same rows of the source's key (a Key source as it is, else a
        key drawn from the source generator), for k-means."""
        key = self.source if isinstance(self.source, Key) else Key(
            key_from_generator(self.source, device))
        return Rows(key, self.lo, self.hi, self.n)

    def bits(self, shape, stream=None, counter=0):
        """Key.bits of these rows (the batch on axis 0 of `shape`, behind
        a tensor of counters' axes)."""
        t = self.source.bits(self._global(shape, 0), stream, counter)
        return self._narrow(t, t.dim() - len(shape))

    randint = Key.randint


def exponential(like, generator=None):
    """Standard exponential noise of like's shape and dtype, from a
    torch.Generator, a Draws or a Key."""
    if isinstance(generator, (Draws, Key)):
        return generator.exponential(like)
    return torch.empty_like(like).exponential_(generator=generator)


def uniform(shape, device, generator=None):
    """f32 uniforms in [0, 1) from a torch.Generator or a Key."""
    if isinstance(generator, Key):
        return generator.uniform(shape)
    return torch.rand(shape, generator=generator, device=device)


def sample_heatmap(prob_map, num_samples: int, rel_threshold=None,
                   replacement: bool = False, generator=None, u=None,
                   gumbel=None, batch_dim=0):
    """Sample (x, y) coordinates from (..., H, W) non-negative maps.

    rel_threshold excludes entries below rel_threshold * max(map).
    u: optional (rows, num_samples) uniforms in [0, 1) for the
    with-replacement draw; gumbel: optional (rows, H*W) Gumbel noise for
    the draw without replacement (rows = prod of the leading dims).
    batch_dim: the leading dim that is the batch, where a Rows generator
    draws a global batch's noise.

    Returns (..., num_samples, 2) f32 coordinates.
    """
    p = prob_map
    H, W = p.shape[-2], p.shape[-1]
    batch_shape = p.shape[:-2]
    flat = p.reshape(-1, H * W)
    below = None
    if rel_threshold is not None:
        below = flat < flat.amax(dim=1, keepdim=True) * rel_threshold

    if replacement:
        w = flat.to(torch.float32)
        if below is not None:
            w = torch.where(below, torch.zeros_like(w), w)
        cdf = torch.cumsum(w, dim=1)
        if u is None and isinstance(generator, Rows):
            u = generator.uniform((*batch_shape, num_samples), flat.device,
                                  batch_dim).reshape(-1, num_samples)
        elif u is None:
            u = uniform((flat.shape[0], num_samples), flat.device,
                        generator)
        u = u.to(device=flat.device, dtype=torch.float32) * cdf[:, -1:]
        idx = torch.searchsorted(cdf, u, right=True).clamp_(max=H * W - 1)
    else:
        logp = torch.log(torch.clamp(flat, min=1e-38))
        if below is not None:
            logp = torch.where(below, torch.full_like(logp, -torch.inf), logp)
        if gumbel is None and isinstance(generator, Rows):
            gumbel = -generator.exponential(
                logp.reshape(*batch_shape, H * W), batch_dim).reshape(
                    logp.shape).log()
        elif gumbel is None:
            # -log(E) with E ~ Exp(1) is a standard Gumbel draw
            gumbel = -exponential(logp, generator).log()
        gumbel = gumbel.to(device=flat.device, dtype=logp.dtype)
        idx = torch.topk(logp + gumbel, num_samples, dim=1).indices

    coords = torch.stack([(idx % W).to(torch.float32),
                          torch.div(idx, W, rounding_mode="floor").to(
                              torch.float32)], dim=-1)
    return coords.reshape(*batch_shape, num_samples, 2)
