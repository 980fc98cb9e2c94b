"""The evcouplings -> evcouplings_torch import alias
(evcouplings_torch.compat), through the cases of tests/test_compat_alias.py:
reference-style imports resolve to the port's modules after the explicit
opt-in and never shadow a real reference package. Then the two aliases
refuse each other in either order, so one process never mixes the two
packages under one name, and the alias module's public names are its JAX
twin's. Run in subprocesses so alias state cannot leak into the rest of
the suite (which imports the real reference via tests/reference_shim.py).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_py(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=240, env=env,
    )


class TestAlias:
    def test_reference_imports_resolve_to_framework(self):
        r = run_py(
            "import evcouplings_torch.compat\n"
            "import evcouplings\n"
            "import evcouplings_torch\n"
            "assert evcouplings is evcouplings_torch\n"
            "from evcouplings.couplings import CouplingsModel\n"
            "from evcouplings_torch.couplings.model import (\n"
            "    CouplingsModel as real)\n"
            "assert CouplingsModel is real\n"
            "from evcouplings.align import Alignment  # noqa: F401\n"
            "from evcouplings.utils import read_config_file  # noqa\n"
            "from evcouplings.utils import SubmitterFactory  # noqa\n"
            "import evcouplings.couplings.pairs as p\n"
            "assert p.__name__ == 'evcouplings_torch.couplings.pairs'\n"
            "import sys\n"
            "assert not [m for m in sys.modules if m.startswith(\n"
            "    ('jax', 'evcouplings_tpu'))]\n"
            "print('ALIAS-OK')\n"
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "ALIAS-OK" in r.stdout

    def test_no_alias_without_opt_in(self):
        r = run_py(
            "import evcouplings_torch\n"
            "import evcouplings_torch.utils.app\n"
            "try:\n"
            "    import evcouplings\n"
            "except ImportError:\n"
            "    print('NOT-ALIASED')\n"
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "NOT-ALIASED" in r.stdout

    def test_refuses_to_shadow_real_package(self):
        r = run_py(
            "import sys, types\n"
            "real = types.ModuleType('evcouplings')\n"
            "real.__file__ = '/opt/reference/evcouplings/__init__.py'\n"
            "sys.modules['evcouplings'] = real\n"
            "try:\n"
            "    import evcouplings_torch.compat\n"
            "except ImportError as e:\n"
            "    assert 'refusing to shadow' in str(e)\n"
            "    assert sys.modules['evcouplings'] is real\n"
            "    print('REFUSED')\n"
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "REFUSED" in r.stdout

    def test_uninstall_restores_clean_state(self):
        r = run_py(
            "import sys\n"
            "import evcouplings_torch.compat as c\n"
            "import evcouplings\n"
            "import evcouplings.utils\n"
            "c.uninstall_alias()\n"
            "assert not [m for m in sys.modules\n"
            "            if m.split('.')[0] == 'evcouplings']\n"
            "try:\n"
            "    import evcouplings\n"
            "except ImportError:\n"
            "    print('CLEAN')\n"
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "CLEAN" in r.stdout


class TestAliasesRefuseEachOther:
    def test_jax_alias_first_then_port(self):
        """The JAX alias installed (whether or not `evcouplings` was
        imported through it yet): the port's alias refuses, and the name
        keeps resolving to the JAX package."""
        for touch in ("", "import evcouplings\n"):
            r = run_py(
                "import evcouplings_tpu.compat\n" + touch +
                "try:\n"
                "    import evcouplings_torch.compat\n"
                "except ImportError as e:\n"
                "    assert 'refusing to shadow' in str(e), e\n"
                "    import evcouplings, evcouplings_tpu\n"
                "    assert evcouplings is evcouplings_tpu\n"
                "    print('PORT-REFUSED')\n"
            )
            assert r.returncode == 0, r.stdout + r.stderr
            assert "PORT-REFUSED" in r.stdout, touch

    def test_port_alias_first_then_jax(self):
        """The port's alias installed: the JAX alias refuses, and the
        name keeps resolving to the port."""
        r = run_py(
            "import evcouplings_torch.compat\n"
            "try:\n"
            "    import evcouplings_tpu.compat\n"
            "except ImportError as e:\n"
            "    assert 'refusing to shadow' in str(e), e\n"
            "    import evcouplings, evcouplings_torch\n"
            "    assert evcouplings is evcouplings_torch\n"
            "    import evcouplings.couplings.model as m\n"
            "    assert m.__name__ == 'evcouplings_torch.couplings.model'\n"
            "    print('JAX-REFUSED')\n"
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "JAX-REFUSED" in r.stdout

    def test_public_names_match_the_jax_twin(self):
        r = run_py(
            "import inspect\n"
            "def names(mod):\n"
            "    return {n for n, v in vars(mod).items()\n"
            "            if not n.startswith('_') and not inspect.ismodule(v)}\n"
            "import evcouplings_torch.compat as port\n"
            "port.uninstall_alias()\n"
            "import evcouplings_tpu.compat as twin\n"
            "assert names(port) == names(twin), (names(port), names(twin))\n"
            "print(sorted(names(port)))\n"
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "install_alias" in r.stdout


class TestAliasEndToEnd:
    def test_reference_style_fit_script(self, tmp_path):
        """A small script written entirely against the reference's
        import paths runs the port's fit through the alias (on the host,
        as the caller asks)."""
        msa = tmp_path / "a.fasta"
        msa.write_text(
            ">s0/1-6\nACDEFG\n>s1/1-6\nACDEFW\n>s2/1-6\nACKEFG\n"
            ">s3/1-6\nYCDEFG\n>s4/1-6\nACDEQG\n>s5/1-6\nACDRFG\n"
        )
        r = run_py(
            "import evcouplings_torch.compat\n"
            "from evcouplings.couplings.tools import run_plmc\n"
            "from evcouplings.couplings.model import CouplingsModel\n"
            "res = run_plmc({msa!r}, {ec!r}, {model!r},\n"
            "               focus_seq='s0/1-6', iterations=5,\n"
            "               device='cpu')\n"
            "m = CouplingsModel({model!r})\n"
            "assert m.L == 6 and m.num_symbols == 21\n"
            "print('E2E-OK', res.num_valid_seqs)\n".format(
                msa=str(msa), ec=str(tmp_path / "ECs.txt"),
                model=str(tmp_path / "m.model"),
            )
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "E2E-OK 6" in r.stdout
