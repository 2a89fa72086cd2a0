"""Serialized serving artifacts: the encoding step as one portable file.

``export_serving(model, ...)`` serializes the model's frozen-dictionary
encoding step ``V -> H`` (the matched-filter activation init followed by
H-only multiplicative updates — exactly ``model.transform``'s compute) as a
self-contained StableHLO artifact via :mod:`jax.export`.  The learned
dictionary, the ConvPlan geometry, the strategy lowering and the
regularizer strengths are baked into the program; the batch dimension is
symbolic by default, so one artifact serves any request size.
``load_serving(path_or_bytes)`` rehydrates a callable that needs jax but
*not* this package — deploy the dictionary to a fleet without shipping
model code, Python pickles, or an RNG (the matched-filter init is
deterministic).

The artifact's signature is ``(V, n_iterations) -> H``: the iteration
count stays a runtime scalar (latency/quality trade-off per request
without re-exporting), while the regularizer strengths are export-time
constants (they select which fused kernels exist in the program).

Reference role: the serving half of ``transform()`` — the reference has no
counterpart (its models can only be pickled together with the library).

With ``include_decoder=True`` the file also carries the reconstruction
``H -> R`` as a second exported function — a complete codec in one
artifact (encode new data, impute/reconstruct from activations).

File format: ``b'TNMFSRV1' + <u32 header length> + <JSON header> +
<concatenated jax.export payloads>`` (the header's ``sections`` dict
gives each payload's name and byte length, in file order).  The header
also carries the metadata needed to call the artifact (shapes, dtypes,
defaults) and provenance for humans.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .utils.validation import require, require_nonneg

_MAGIC = b'TNMFSRV1'


def _jax_export():
    """``jax.export``, with a FlatBuffers runtime for its (de)serializer.

    JAX lists ``flatbuffers`` as an optional dependency, and some JAX
    installations lack it; then the copy in :mod:`tnmf_tpu._vendor` is
    registered under that name before ``jax.export`` first needs it.  The
    registration is process-wide: any later ``import flatbuffers`` in the
    same process gets this copy, which has no ``flexbuffers`` module."""
    try:
        import flatbuffers  # noqa: F401
    except ImportError:
        import sys
        from ._vendor import flatbuffers
        sys.modules['flatbuffers'] = flatbuffers
        for sub in ('builder', 'compat', 'encode', 'number_types', 'packer',
                    'table', 'util'):
            sys.modules['flatbuffers.' + sub] = getattr(flatbuffers, sub)
    from jax import export
    return export


def export_serving(model, *,
                   n_iterations: int = 100,
                   sparsity_H: float = 0.,
                   inhibition_strength: float = 0.,
                   cross_atom_inhibition_strength: float = 0.,
                   l2_H: float = 0.,
                   batch_size: Optional[int] = None,
                   path: Optional[str] = None,
                   platforms: Optional[Sequence[str]] = None,
                   input_dtype=None,
                   include_decoder: bool = False,
                   sample_shape: Optional[Tuple[int, ...]] = None,
                   solver: str = 'mu') -> bytes:
    """Serialize ``model``'s encoding step to a self-contained artifact.

    Parameters
    ----------
    model : TransformInvariantNMF
        A fitted (or checkpoint-loaded / ``set_dictionary``-initialized)
        single-device model.  The artifact encodes against the *current*
        dictionary with the sample geometry of the last fit.
    n_iterations : int
        Default MU iteration count recorded in the artifact header; the
        exported function also takes the count as a runtime scalar.
    sparsity_H, inhibition_strength, cross_atom_inhibition_strength, l2_H : float
        Regularizer strengths, baked in as constants (same semantics as
        ``transform``'s kwargs; ``l2_H`` is the ridge term — ``ortho_W``
        does not apply here, the dictionary is frozen).
    batch_size : int, optional
        Fix the batch dimension.  Default: symbolic — one artifact serves
        any batch size.
    path : str, optional
        Also write the artifact to ``path`` (atomically).
    platforms : sequence of str, optional
        Lowering platforms (e.g. ``('cuda', 'cpu')``) for a multi-platform
        artifact; default: the current JAX backend.
    input_dtype : dtype-like, optional
        Input array dtype the artifact accepts (cast to the model's
        compute dtype inside).  Default: the model dtype, or float32 for
        bfloat16 models (bf16 host arrays are awkward to produce).
    include_decoder : bool
        Also export the reconstruction ``H -> R`` as a second function in
        the same file — the loaded artifact then exposes
        ``inverse_transform`` and is a complete codec (encode new data,
        impute/reconstruct from activations) with no model state anywhere.
    sample_shape : tuple of int, optional
        Export for this sample geometry instead of the last fit's —
        required when the model only carries a dictionary (a W-only
        checkpoint or ``set_dictionary``) and no plan yet.
    solver : str
        ``'mu'`` (default) bakes MU H-refinement steps; ``'hals'`` bakes
        exact H coordinate sweeps (:mod:`tnmf_tpu.engine_hals` — the
        Gram of the frozen dictionary folds into the artifact, each
        "iteration" is one Gauss–Seidel pass) for the plain-NMF
        geometry — or, on the shift-invariant ``'full'`` geometry, one
        exact phase-blocked sweep per iteration
        (:mod:`tnmf_tpu.engine_hals_conv`) — starting from the same
        matched-filter init as the MU path.  HALS artifacts reject
        inhibition (MU-only) and reach a given residual in far fewer
        iterations.

    Returns the artifact bytes.
    """
    import jax
    import jax.numpy as jnp
    jax_export = _jax_export()
    from jax import lax

    from . import engine

    if hasattr(model, 'atom_shapes'):  # MultiScaleTNMF
        if l2_H:
            raise ValueError('l2_H is not supported by the MultiScaleTNMF '
                             'serving export yet; only sparsity_H applies')
        return _export_serving_multiscale(
            model, n_iterations=n_iterations, sparsity_H=sparsity_H,
            inhibition_strength=inhibition_strength,
            cross_atom_inhibition_strength=cross_atom_inhibition_strength,
            batch_size=batch_size, path=path, platforms=platforms,
            input_dtype=input_dtype, include_decoder=include_decoder,
            sample_shape=sample_shape)
    if getattr(model, '_W', None) is None:
        raise RuntimeError(
            'export_serving() requires a fitted model, a loaded checkpoint '
            'or set_dictionary(); call fit() first')
    if getattr(model, '_plan', None) is None and sample_shape is None:
        raise RuntimeError(
            'export_serving(): the model has a dictionary but no sample '
            'geometry yet (W-only checkpoint / set_dictionary); pass '
            'sample_shape=... or run one fit/transform first')
    if getattr(model, '_mesh', None) is not None:
        raise ValueError(
            'export_serving() produces a single-device artifact; export '
            'from a mesh-free model (the dictionary transfers via '
            'set_dictionary())')
    require_nonneg(sparsity_H=sparsity_H,
                   inhibition_strength=inhibition_strength,
                   cross_atom_inhibition_strength=cross_atom_inhibition_strength,
                   l2_H=l2_H)

    from .ops.modes import ConvPlan

    W = jnp.asarray(model._W)
    if sample_shape is not None:
        # derive plan/strategy for the requested geometry (same resolution
        # chain as _initialize_matrices, models/tnmf.py)
        plan = ConvPlan.create(model._reconstruction_mode,
                               tuple(int(s) for s in sample_shape),
                               model.atom_shape, model._fft_policy,
                               precision=model._precision)
        strategy = engine.resolve_strategy(
            model._strategy_request, plan, model.n_atoms * model.n_transforms,
            W.shape[1])
        if model._group is not None:
            strategy = (strategy, model._group)
    else:
        plan = model._plan
        strategy = model._strategy
    beta = model._beta
    n_atoms = model.n_atoms
    n_transforms = model.n_transforms
    kernels = model._kernels
    if kernels is None:  # dictionary installed without a fit on this object
        kernels = tuple(jnp.asarray(k, W.dtype)
                        for k in model._inhibition_kernels_1D)
    use_inh = inhibition_strength > 0
    use_cross = cross_atom_inhibition_strength > 0
    s_c = jnp.asarray(sparsity_H, W.dtype)
    i_c = jnp.asarray(inhibition_strength, W.dtype)
    x_c = jnp.asarray(cross_atom_inhibition_strength, W.dtype)
    l2_c = jnp.asarray(l2_H, W.dtype) if l2_H > 0 else None
    ops = engine.get_ops(strategy)

    if solver not in ('mu', 'hals'):
        raise ValueError(f"solver must be 'mu' or 'hals', got {solver!r}")
    if solver == 'hals':
        from . import engine_hals
        if use_inh or use_cross:
            raise ValueError('inhibition regularizers are MU-only under '
                             "solver='hals'")
        if beta != 2.0 or n_transforms > 1:
            raise ValueError("solver='hals' artifacts require beta_loss=2 "
                             'and no transform group')
        acc = jnp.promote_types(W.dtype, jnp.float32)
        l1_h = jnp.asarray(sparsity_H, acc)
        l2_h = jnp.asarray(l2_H, acc)
        if int(np.prod(plan.transform_shape)) != 1:
            # shift-invariant geometry: bake exact phase-blocked H sweeps
            # against the frozen dictionary (engine_hals_conv); each
            # "iteration" of the artifact is one full exact sweep
            from . import engine_hals_conv as ehc
            if not ehc.applicable(plan):
                raise ValueError(
                    "export_serving(solver='hals') requires the "
                    "degenerate plain-NMF geometry or "
                    "reconstruction_mode='full' (shift-invariant exact "
                    'CD); other modes have boundary-clipped footprints')
            G = ehc.gram_W(W, plan.lax_precision)

            def serve(V, n_iters):
                V = V.astype(W.dtype)
                Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
                H0 = engine.correlate_init_H(Vp, V, W, plan=plan,
                                             strategy=strategy,
                                             n_atoms=n_atoms)
                E_pad, H_pm = ehc._encode(V, W, H0, plan)

                def body(_, carry):
                    return ehc.h_phase_sweep(carry[0], carry[1], W, G,
                                             l1_h, l2_h, plan=plan,
                                             inner=1)

                E_pad, H_pm = lax.fori_loop(0, n_iters, body,
                                            (E_pad, H_pm))
                return ehc._decode_h(H_pm, plan)
        else:
            from . import engine_hals_conv as ehc
            W2 = W.reshape(W.shape[0], -1)
            G = ehc.gram_W(W, plan.lax_precision)      # baked (m, m) Gram

            def serve(V, n_iters):
                V = V.astype(W.dtype)
                Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
                H0 = engine.correlate_init_H(Vp, V, W, plan=plan,
                                             strategy=strategy,
                                             n_atoms=n_atoms)
                H2 = H0.reshape(H0.shape[0], H0.shape[1])
                P = jnp.matmul(V.reshape(V.shape[0], -1), W2.astype(acc).T,
                               precision=plan.lax_precision,
                               preferred_element_type=acc)

                def body(_, H2):
                    return engine_hals._sweep_H(H2, G, P, l1_h, l2_h)

                H2 = lax.fori_loop(0, n_iters, body, H2)
                return H2.reshape(H0.shape)
    else:
        def serve(V, n_iters):
            V = V.astype(W.dtype)
            Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
            # mirror the model's matched-filter init (_initialize_matrices):
            # a beta != 2 fft loop consumes the canonical V (spectral
            # prepared domain), every other configuration the prepared
            # tensor; the matched filter always correlates the prepared
            # (Euclidean) tensor
            H0 = engine.correlate_init_H(Vp, V, W, plan=plan,
                                         strategy=strategy, n_atoms=n_atoms)
            Vloop = (Vp if beta == 2.0 or engine.beta_prepares_data(strategy)
                     else V)
            Hph = engine._enc_h(H0, plan, strategy)

            def body(_, Hph):
                return engine._mu_H(ops, Vloop, W, Hph, s_c, i_c, x_c,
                                    kernels, plan=plan, use_inhibition=use_inh,
                                    use_cross=use_cross, beta=beta, l2=l2_c)

            Hph = lax.fori_loop(0, n_iters, body, Hph)
            H = engine._dec_h(Hph, plan, strategy, W.shape[0])
            if n_transforms > 1:
                H = H.reshape((H.shape[0], n_atoms, n_transforms)
                              + H.shape[2:])
            return H

    if input_dtype is not None:
        in_dtype = jnp.dtype(input_dtype)
    elif W.dtype == jnp.bfloat16:
        in_dtype = jnp.dtype(jnp.float32)
    else:
        in_dtype = W.dtype
    if batch_size is None:
        (b,) = jax_export.symbolic_shape('b')
    else:
        b = int(batch_size)
    plats = list(platforms) if platforms is not None else None
    v_spec = jax.ShapeDtypeStruct((b, W.shape[1]) + plan.sample_shape,
                                  in_dtype)
    n_spec = jax.ShapeDtypeStruct((), jnp.int32)
    exported = jax_export.export(jax.jit(serve), platforms=plats)(v_spec, n_spec)
    payloads = {'transform': exported.serialize()}

    h_shape = ((n_atoms, n_transforms) if n_transforms > 1 else (n_atoms,))
    if include_decoder:
        def decode(H):
            if n_transforms > 1:
                H = H.reshape((H.shape[0], n_atoms * n_transforms)
                              + H.shape[3:])
            R = engine.reconstruct(W, H.astype(W.dtype),
                                   plan=plan, strategy=strategy)
            return R.astype(in_dtype)

        bd = b if batch_size is not None else jax_export.symbolic_shape('b')[0]
        h_spec = jax.ShapeDtypeStruct(
            (bd,) + h_shape + plan.transform_shape, in_dtype)
        payloads['inverse_transform'] = jax_export.export(
            jax.jit(decode), platforms=plats)(h_spec).serialize()
    header = {
        'format': 1,
        'sections': {k: len(v) for k, v in payloads.items()},
        'library': 'tnmf_tpu',
        'n_iterations': int(n_iterations),
        'input_shape': ['b' if batch_size is None else int(batch_size),
                        int(W.shape[1])] + [int(x) for x in plan.sample_shape],
        'input_dtype': np.dtype(in_dtype).name,
        'h_leading': [int(x) for x in h_shape],
        'n_atoms': int(n_atoms),
        'n_transforms': int(n_transforms),
        'mode': plan.mode,
        'atom_shape': [int(x) for x in plan.atom_shape],
        'platforms': list(exported.platforms),
        'sparsity_H': float(sparsity_H),
        'inhibition_strength': float(inhibition_strength),
        'cross_atom_inhibition_strength': float(cross_atom_inhibition_strength),
        'l2_H': float(l2_H),
        'beta_loss': float(beta),
        'solver': solver,
    }
    return _assemble(header, payloads, path)


def _assemble(header: dict, payloads: dict, path: Optional[str]) -> bytes:
    """Magic + length-prefixed JSON header + concatenated payloads; atomic
    file write when ``path`` is given."""
    head = json.dumps(header).encode('utf-8')
    blob = (_MAGIC + struct.pack('<I', len(head)) + head
            + b''.join(payloads.values()))
    if path is not None:
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix='.tmp')
        try:
            with os.fdopen(fd, 'wb') as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    return blob


def _export_serving_multiscale(model, *, n_iterations, sparsity_H,
                               inhibition_strength,
                               cross_atom_inhibition_strength,
                               batch_size, path, platforms, input_dtype,
                               include_decoder, sample_shape) -> bytes:
    """Multi-scale artifact: one exported function encoding V into the
    per-scale activation tuple (joint frozen-dictionary block MU updates),
    optionally plus the summed reconstruction as decoder."""
    import jax
    import jax.numpy as jnp
    jax_export = _jax_export()
    from jax import lax

    from . import engine
    from .models import multiscale as ms
    from .ops.modes import ConvPlan

    if getattr(model, '_Ws', None) is None:
        raise RuntimeError(
            'export_serving() requires a fitted model or a loaded '
            'checkpoint; call fit() first')
    if getattr(model, '_plans', None) is None and sample_shape is None:
        raise RuntimeError(
            'export_serving(): the model has dictionaries but no sample '
            'geometry yet; pass sample_shape=... or run one fit first')
    if getattr(model, '_mesh', None) is not None:
        raise ValueError('export_serving() produces a single-device '
                         'artifact; export from a mesh-free model')
    if inhibition_strength or cross_atom_inhibition_strength:
        raise ValueError('MultiScaleTNMF has no lateral-inhibition '
                         'regularizers; only sparsity_H applies')

    Ws = tuple(jnp.asarray(w) for w in model._Ws)
    dt = Ws[0].dtype
    beta = model._beta
    if sample_shape is not None:
        sshape = tuple(int(s) for s in sample_shape)
        plans = tuple(ConvPlan.create(model._mode, sshape, a,
                                      precision=model._precision)
                      for a in model.atom_shapes)
        # same resolution chain as MultiScaleTNMF._initialize
        strategies = tuple(
            engine.resolve_strategy('auto', p, m, int(Ws[0].shape[1]),
                                    allow_dot=False)
            for p, m in zip(plans, model.n_atoms))
    else:
        plans, strategies = model._plans, model._strategies
    if np.isscalar(sparsity_H):
        sparsity_H = (float(sparsity_H),) * model.n_scales
    sparsity_H = tuple(float(s) for s in sparsity_H)
    require(len(sparsity_H) == model.n_scales and min(sparsity_H) >= 0,
            'sparsity_H must give one value >= 0 per scale')
    sp = tuple(jnp.asarray(s, dt) for s in sparsity_H)

    def serve(V, n_iters):
        V = V.astype(dt)
        Vps = tuple(engine.prepare_data(V, plan=p, strategy=s)
                    for p, s in zip(plans, strategies))
        Hs0 = tuple(
            engine.correlate_init_H(
                (engine.prepare_data(V, plan=p, strategy=s)
                 if beta != 2.0 else vp),
                V, w, plan=p, strategy=s, n_atoms=w.shape[0])
            for vp, w, p, s in zip(Vps, Ws, plans, strategies))
        Vloop = (V,) * model.n_scales if beta != 2.0 else Vps

        def body(_, Hs):
            return ms._step(V, Vloop, Ws, Hs, sp, None, plans=plans,
                            strategies=strategies, update_H=True,
                            update_W=False, beta=beta)[1]

        Hs = lax.fori_loop(0, n_iters, body,
                           ms._enc_hs(Hs0, plans, strategies))
        return ms._dec_hs(Hs, Ws, plans, strategies)

    if input_dtype is not None:
        in_dtype = jnp.dtype(input_dtype)
    elif dt == jnp.bfloat16:
        in_dtype = jnp.dtype(jnp.float32)
    else:
        in_dtype = dt
    if batch_size is None:
        (b,) = jax_export.symbolic_shape('b')
    else:
        b = int(batch_size)
    plats = list(platforms) if platforms is not None else None
    n_ch = int(Ws[0].shape[1])
    v_spec = jax.ShapeDtypeStruct((b, n_ch) + plans[0].sample_shape, in_dtype)
    n_spec = jax.ShapeDtypeStruct((), jnp.int32)
    exported = jax_export.export(jax.jit(serve), platforms=plats)(v_spec, n_spec)
    payloads = {'transform': exported.serialize()}

    if include_decoder:
        def decode(Hs):
            Hd = ms._enc_hs(tuple(h.astype(dt) for h in Hs),
                            plans, strategies)
            return ms._reconstruct(Ws, Hd, plans, strategies).astype(in_dtype)

        bd = b if batch_size is not None else jax_export.symbolic_shape('b')[0]
        h_specs = tuple(
            jax.ShapeDtypeStruct((bd, m) + p.transform_shape, in_dtype)
            for m, p in zip(model.n_atoms, plans))
        payloads['inverse_transform'] = jax_export.export(
            jax.jit(decode), platforms=plats)(h_specs).serialize()

    header = {
        'format': 1,
        'sections': {k: len(v) for k, v in payloads.items()},
        'library': 'tnmf_tpu',
        'multiscale': int(model.n_scales),
        'n_iterations': int(n_iterations),
        'input_shape': ['b' if batch_size is None else int(batch_size),
                        n_ch] + [int(x) for x in plans[0].sample_shape],
        'input_dtype': np.dtype(in_dtype).name,
        'n_atoms': [int(m) for m in model.n_atoms],
        'n_transforms': 1,
        'mode': plans[0].mode,
        'atom_shape': [[int(x) for x in a] for a in model.atom_shapes],
        'platforms': list(exported.platforms),
        'sparsity_H': list(sparsity_H),
        'beta_loss': float(beta),
    }
    return _assemble(header, payloads, path)


class ServingModel:
    """A loaded serving artifact: ``transform(V)`` encodes against the
    baked-in dictionary.  Construct via :func:`load_serving`."""

    def __init__(self, exported, header: dict, decoder=None):
        self._exported = exported
        self._decoder = decoder
        self.header = header

    @property
    def n_atoms(self) -> int:
        return self.header['n_atoms']

    @property
    def platforms(self):
        return tuple(self.header['platforms'])

    def transform(self, V, n_iterations: Optional[int] = None):
        """Infer activations for ``V`` (``(n, channels, *sample_shape)``)
        with ``n_iterations`` MU refinement steps (default: the count
        recorded at export time).  Multi-scale artifacts return the
        per-scale activation tuple."""
        import jax.numpy as jnp

        n = self.header['n_iterations'] if n_iterations is None else n_iterations
        V = jnp.asarray(np.asarray(V), jnp.dtype(self.header['input_dtype']))
        exp_shape = self.header['input_shape']
        if (V.ndim != len(exp_shape)
                or any(isinstance(e, int) and e != s
                       for e, s in zip(exp_shape, V.shape))):
            raise ValueError(
                f'input shape {tuple(V.shape)} does not match the '
                f'artifact signature {tuple(exp_shape)}')
        H = self._exported.call(V, jnp.asarray(n, jnp.int32))
        if isinstance(H, (tuple, list)):  # multi-scale: per-scale tuple
            return tuple(np.asarray(h) for h in H)
        return np.asarray(H)

    __call__ = transform

    def warmup(self, batch_sizes=(1,)) -> 'ServingModel':
        """Pay the per-batch-shape compile cost up front (a zeros request
        per listed batch size, one refinement iteration) so the first real
        request serves at steady-state latency.  Returns ``self``."""
        shape = self.header['input_shape']
        for n in batch_sizes:
            V0 = np.zeros([int(n)] + [int(s) for s in shape[1:]],
                          np.dtype(self.header['input_dtype']))
            self.transform(V0, n_iterations=1)
        return self

    def inverse_transform(self, H) -> np.ndarray:
        """Reconstruction from activations (present when the artifact was
        exported with ``include_decoder=True``).  Multi-scale artifacts
        take the per-scale activation tuple."""
        import jax.numpy as jnp

        if self._decoder is None:
            raise RuntimeError(
                'this artifact has no decoder section; export with '
                'include_decoder=True to serve inverse_transform')
        in_dt = jnp.dtype(self.header['input_dtype'])
        if 'multiscale' in self.header:
            Hs = tuple(jnp.asarray(np.asarray(h), in_dt) for h in H)
            return np.asarray(self._decoder.call(Hs))
        H = jnp.asarray(np.asarray(H), in_dt)
        return np.asarray(self._decoder.call(H))


def load_serving(src: Union[str, bytes, os.PathLike]) -> ServingModel:
    """Load a serving artifact written by :func:`export_serving` from a
    path or raw bytes."""
    jax_export = _jax_export()

    if isinstance(src, (str, os.PathLike)):
        with open(src, 'rb') as f:
            blob = f.read()
    else:
        blob = bytes(src)
    if blob[:len(_MAGIC)] != _MAGIC:
        raise ValueError('not a tnmf_tpu serving artifact (bad magic)')
    off = len(_MAGIC)
    (hlen,) = struct.unpack('<I', blob[off:off + 4])
    off += 4
    header = json.loads(blob[off:off + hlen].decode('utf-8'))
    if header.get('format', 0) > 1:
        raise ValueError(
            f"artifact format {header['format']} is newer than this "
            'library understands; upgrade tnmf_tpu')
    off += hlen
    sections = {}
    for name, length in header['sections'].items():
        sections[name] = jax_export.deserialize(
            bytearray(blob[off:off + length]))
        off += length
    return ServingModel(sections['transform'], header,
                        decoder=sections.get('inverse_transform'))
