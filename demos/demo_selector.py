"""Demo selector: entry page mapping demo names to modules.

Run with:  streamlit run demos/demo_selector.py  (or headless via
``python demos/demo_selector.py [name]`` using the widget defaults).
"""

import os
import sys
from importlib import import_module

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tnmf_tpu.utils.demo import st  # noqa: E402

DEMO_NAME_DICT = {
    '1-D Synthetic Signals': ('synthetic_signals', {'n_dims': 1}),
    '2-D Synthetic Signals': ('synthetic_signals', {'n_dims': 2}),
    'Test Image': ('demo_image', {}),
    'Image Inpainting (masked fit)': ('demo_inpainting', {}),
    'Hyperparameter Sweep (vmapped)': ('demo_sweep', {}),
}


def main(demo_name: str = '2-D Synthetic Signals'):
    st.title('Transform-Invariant NMF (JAX)')
    progress_bar = st.sidebar.progress(1.)

    verbose = st.sidebar.checkbox('Verbose', True)
    names = list(DEMO_NAME_DICT.keys())
    selected = st.sidebar.selectbox('Demo example', names, index=names.index(demo_name))
    seed = int(st.sidebar.number_input('Random seed', value=42))
    np.random.seed(seed)

    module_name, demo_args = DEMO_NAME_DICT[selected]
    demo_module = import_module(module_name)
    demo_module.main(progress_bar, verbose=verbose, **demo_args)


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else '2-D Synthetic Signals')
