"""
Fake HMMER and HHsuite binaries and prepared search outputs, for the
port's tests of the search protocols and for chip_smoke.py (no JAX; the
standard library, and pandas where a table is written).

The fakes are bash scripts that keep each tool's command-line contract:
jackhmmer and hmmsearch need -A and -o, find their query (or HMM) and
database as the last two arguments, and copy the prepared Stockholm,
tblout and domtblout of the database they were given; hmmbuild writes an
HMM file; hhfilter needs -i, -o, -id and -M and drops named records.
Hit names of searches against a SIFTS sequence file are UniProt-style
db|AC|ID, as SIFTS.create_sequence_file writes them.
"""

import os
import shlex

_PARSE_OUTPUTS = """ALI=; OUT=; TBL=; DOM=
args=("$@")
for ((k=0; k<$#; k++)); do
  case "${args[k]}" in
    -A) ALI="${args[k+1]}";;
    -o) OUT="${args[k+1]}";;
    --tblout) TBL="${args[k+1]}";;
    --domtblout) DOM="${args[k+1]}";;
  esac
done
"""


def _script(path, body):
    with open(path, "w") as f:
        f.write("#!/bin/bash\nset -e\n" + body)
    os.chmod(path, 0o755)
    return str(path)


def fake_search(path, outputs):
    """A jackhmmer (or hmmsearch) stand-in. outputs: {database path:
    (Stockholm, tblout, domtblout) paths}; another database exits 66."""
    cases = "".join(
        "  {}) cp {} \"$ALI\"; cp {} \"$TBL\"; cp {} \"$DOM\";;\n".format(
            *(shlex.quote(str(p)) for p in (db, sto, tbl, dom)))
        for db, (sto, tbl, dom) in outputs.items())
    return _script(path, _PARSE_OUTPUTS + (
        "[ -n \"$ALI\" ] && [ -n \"$OUT\" ] || exit 64\n"
        "IN=\"${args[$#-2]}\"; DB=\"${args[$#-1]}\"\n"
        "[ -f \"$IN\" ] && [ -f \"$DB\" ] || exit 65\n"
        "case \"$DB\" in\n" + cases + "  *) exit 66;;\nesac\n"
        "echo done > \"$OUT\"\n"))


def fake_hmmbuild(path):
    """hmmbuild: writes a one-line HMM file (second to last argument)
    from an existing alignment (last argument)."""
    return _script(path, (
        "args=(\"$@\")\nOUT=\n"
        "for ((k=0; k<$#; k++)); do\n"
        "  [ \"${args[k]}\" = \"-o\" ] && OUT=\"${args[k+1]}\"\n"
        "done\n"
        "HMM=\"${args[$#-2]}\"; ALI=\"${args[$#-1]}\"\n"
        "[ -f \"$ALI\" ] || exit 65\n"
        "echo 'HMMER3/f fake profile' > \"$HMM\"\n"
        "echo ok > \"$OUT\"\n"))


def fake_hhfilter(path, drop):
    """hhfilter: copies the -i FASTA to -o (A3M), leaving out the records
    whose identifier is in `drop` (plain bash, no other program)."""
    return _script(path, (
        "IN=; OUTF=; ID=; M=\nargs=(\"$@\")\n"
        "for ((k=0; k<$#; k++)); do\n"
        "  case \"${args[k]}\" in\n"
        "    -i) IN=\"${args[k+1]}\";;\n"
        "    -o) OUTF=\"${args[k+1]}\";;\n"
        "    -id) ID=\"${args[k+1]}\";;\n"
        "    -M) M=\"${args[k+1]}\";;\n"
        "  esac\n"
        "done\n"
        "[ -f \"$IN\" ] && [ -n \"$OUTF\" ] && [ -n \"$ID\" ] "
        "&& [ \"$M\" = first ] || exit 64\n"
        "DROP=(@DROP@)\nkeep=1\n"
        "while IFS= read -r line; do\n"
        "  if [[ $line == '>'* ]]; then\n"
        "    id=${line#>}; id=${id%% *}; keep=1\n"
        "    for d in \"${DROP[@]}\"; do [[ $id == \"$d\" ]] && keep=0; done\n"
        "  fi\n"
        "  if [[ $keep == 1 ]]; then printf '%s\\n' \"$line\"; fi\n"
        "done < \"$IN\" > \"$OUTF\"\n").replace(
            "@DROP@", " ".join(shlex.quote(d) for d in drop)))


def stockholm(rows, descriptions=None, rf=None):
    """Stockholm text of [(id, aligned sequence)], with #=GS DE lines
    ({id: text}) and a #=GC RF line."""
    width = max(len(name) for name, _ in rows + [("#=GC RF", "")])
    lines = ["# STOCKHOLM 1.0"]
    lines += ["#=GS {} DE {}".format(name, text)
              for name, text in (descriptions or {}).items()]
    lines += ["{} {}".format(name.ljust(width), seq) for name, seq in rows]
    if rf is not None:
        lines.append("{} {}".format("#=GC RF".ljust(width), rf))
    return "\n".join(lines + ["//"]) + "\n"


def hit_tables(hits, query_name, query_len):
    """(tblout, domtblout) text of [(target_name, target_len, ali_from,
    ali_to, score)], one domain per hit."""
    tbl = ["# target name  accession  query name  accession  E-value  "
           "score  bias"]
    dom = ["# target name  accession  tlen  query name  accession  qlen  "
           "E-value  score  bias  #  of  c-Evalue  i-Evalue  score  bias  "
           "from  to  ali_from  ali_to  env_from  env_to  acc  description"]
    for name, tlen, start, end, score in hits:
        evalue = "{:.1e}".format(10.0 ** (-score / 10))
        tbl.append("{} - {} - {} {:.1f} 0.0 {} {:.1f} 0.0 1.0 1 0 0 1 1 1 1 "
                   "-".format(name, query_name, evalue, score, evalue, score))
        dom.append("{} - {} {} - {} {} {:.1f} 0.0 1 1 {} {} {:.1f} 0.0 1 {} "
                   "{} {} {} {} 0.99 -".format(
                       name, tlen, query_name, query_len, evalue, score,
                       evalue, evalue, score, query_len, start, end, start,
                       end))
    return "\n".join(tbl + ["#"]) + "\n", "\n".join(dom + ["#"]) + "\n"


def write_outputs(directory, name, sto_text, hits, query_name, query_len):
    """The prepared (Stockholm, tblout, domtblout) files of one search."""
    tbl, dom = hit_tables(hits, query_name, query_len)
    paths = [os.path.join(directory, name + ext)
             for ext in (".sto", ".tbl", ".dom")]
    for path, text in zip(paths, (sto_text, tbl, dom)):
        with open(path, "w") as f:
            f.write(text)
    return tuple(paths)


def read_rows(a2m_path):
    """[(identifier, aligned sequence)] of an a2m/FASTA alignment."""
    rows, name, seq = [], None, []
    with open(a2m_path) as f:
        for line in f:
            if line.startswith(">"):
                if name is not None:
                    rows.append((name, "".join(seq)))
                name, seq = line[1:].split()[0], []
            else:
                seq.append(line.strip())
    rows.append((name, "".join(seq)))
    return rows


def as_jackhmmer_result(rows, annotate_every=0):
    """Alignment rows (query first) as jackhmmer's Stockholm, with
    UniProt-style #=GS DE annotation on every annotate_every-th row, and
    one hit per row for the hit tables."""
    descriptions = {}
    if annotate_every:
        for k, (row_id, _) in enumerate(rows[1::annotate_every]):
            descriptions[row_id] = (
                "protein {} OS=Organism {} n={} Tax=Taxon{} RepID=R{}".format(
                    k, k % 7, 1 + k % 4, k % 5, k))
    L = len(rows[0][1])
    hits = [(row_id, L, 1, L, 200.0 - 0.01 * k)
            for k, (row_id, _) in enumerate(rows[1:])]
    return stockholm(rows, descriptions), hits


def sifts_search(query_header, query_seq, hits):
    """What a search of the query against a SIFTS sequence file finds.

    hits: [(db|AC|ID, first residue number, target residue the hit lacks
    or None)]; the query's residues are numbered from its header's start.
    Returns (jackhmmer Stockholm: query first, hmmsearch Stockholm: RF
    line and hits, hit list for hit_tables, [(db|AC|ID, sequence)] for
    the SIFTS sequence file)."""
    start = int(query_header.rsplit("/", 1)[1].split("-")[0])
    rows, table, entries = [], [], []
    for name, first, gap in hits:
        seq = list(query_seq)
        if gap is not None:
            seq[gap - start] = "-"
        aligned = "".join(seq)
        n = len(aligned.replace("-", ""))
        rows.append(("{}/{}-{}".format(name, first, first + n - 1), aligned))
        table.append((rows[-1][0].split("/")[0], first + n - 1, first,
                      first + n - 1, 100.0 - len(table)))
        entries.append((name, "M" * (first - 1) + aligned.replace("-", "")))
    jack = stockholm([(query_header, query_seq)] + rows)
    hmm = stockholm(rows, rf="x" * len(query_seq))
    return jack, hmm, table, entries


def write_sequence_file(path, entries):
    """A SIFTS sequence file: FASTA with db|AC|ID headers."""
    with open(path, "w") as f:
        for name, seq in entries:
            f.write(">{} sequence of {}\n{}\n".format(name, name, seq))
    return str(path)


def homolog_rows(rows, pdb_id, uniprot_ac, shift, gap):
    """The SIFTS rows of pdb_id reassigned to a homolog (uniprot_ac) whose
    numbering is the target's plus `shift`, and that lacks target residue
    `gap` (its numbering closes up after it): each segment is split around
    the missing residue."""
    out = []
    for row in rows:
        if row["pdb_id"] != pdb_id:
            out.append(row)
            continue
        u0, u1 = row["uniprot_start"], row["uniprot_end"]
        r0 = row["resseq_start"]
        offset = int(row["coord_start"]) - r0
        for lo, hi, to_homolog in ((u0, min(u1, gap - 1), shift),
                                   (max(u0, gap + 1), u1, shift - 1)):
            if lo > hi:
                continue
            resseq = (r0 + lo - u0, r0 + hi - u0)
            out.append(dict(row, uniprot_ac=uniprot_ac,
                            resseq_start=resseq[0], resseq_end=resseq[1],
                            coord_start=str(resseq[0] + offset),
                            coord_end=str(resseq[1] + offset),
                            uniprot_start=lo + to_homolog,
                            uniprot_end=hi + to_homolog))
    return out


# the small structure set's search: the target itself, and a homolog
# (3ccc's chain) numbered +90 that lacks target residue 16
SMALL_HOMOLOG = ("tr|HOM_ONE|HOM1_XENLA", "HOM_ONE", 90, 16)


def small_sifts_search(directory, rows, query_header, query_seq):
    """SIFTS table rows, sequence file and prepared search outputs of the
    small structure set (tests/compare_fixtures.py small_structure_set)
    with 3ccc reassigned to SMALL_HOMOLOG. Returns (rows, sequence file,
    {"jackhmmer": outputs, "hmmsearch": outputs})."""
    name, ac, shift, gap = SMALL_HOMOLOG
    rows = homolog_rows(rows, "3ccc", ac, shift, gap)
    start = int(query_header.rsplit("/", 1)[1].split("-")[0])
    jack, hmm, table, entries = sifts_search(
        query_header, query_seq,
        [("sp|TARGET_SEQ|TGT_SEQ", start, None), (name, start + shift, gap)])
    seqs = write_sequence_file(os.path.join(directory, "pdb_seqres.fa"),
                               entries)
    qname, qlen = query_header.split("/")[0], len(query_seq)
    return rows, seqs, {
        "jackhmmer": write_outputs(directory, "sifts_jackhmmer", jack,
                                   table, qname, qlen),
        "hmmsearch": write_outputs(directory, "sifts_hmmsearch", hmm,
                                   table, qname, qlen)}


def full_sifts_search(directory, query_header, query_seq,
                      name="sp|TARGET|TGT_FULL"):
    """Sequence file and prepared jackhmmer outputs of a search that finds
    the target itself (tests/compare_fixtures.py full_structure_set)."""
    start = int(query_header.rsplit("/", 1)[1].split("-")[0])
    jack, _, table, entries = sifts_search(query_header, query_seq,
                                           [(name, start, None)])
    seqs = write_sequence_file(os.path.join(directory, "pdb_seqres.fa"),
                               entries)
    return seqs, write_outputs(directory, "sifts_jackhmmer", jack, table,
                               query_header.split("/")[0], len(query_seq))


def search_job_files(directory, a2m, sifts_rows, small=True,
                     drop_every=7):
    """What a job of align `standard` (jackhmmer, hhfilter) and compare
    `by_alignment` needs, made from an a2m focus alignment whose first row
    is the target: a stand-in uniref90 database whose search returns the
    alignment (query first, annotated), the target's full sequence file,
    the SIFTS table and sequence file (small: small_sifts_search over
    sifts_rows; else full_sifts_search), one fake jackhmmer for both
    databases and a fake hhfilter that drops every drop_every-th row.
    Returns {name: path} and the dropped identifiers under "dropped"."""
    import pandas as pd

    os.makedirs(directory, exist_ok=True)
    rows = read_rows(a2m)
    header, seq = rows[0]
    name = header.split("/")[0]
    sto, hits = as_jackhmmer_result(rows, annotate_every=10)
    uniref = os.path.join(directory, "uniref90.fa")
    with open(uniref, "w") as f:
        f.write(">stand_in\nACD\n")
    sequence_file = os.path.join(directory, "target_full.fa")
    with open(sequence_file, "w") as f:
        f.write(">{}\n{}\n".format(name, seq))
    if small:
        sifts_rows, seqs, outputs = small_sifts_search(
            directory, sifts_rows, header, seq)
        sifts_outputs = outputs["jackhmmer"]
    else:
        seqs, sifts_outputs = full_sifts_search(directory, header, seq)
    table = os.path.join(directory, "sifts_search.csv")
    pd.DataFrame(sifts_rows).to_csv(table, index=False)
    dropped = [row_id for row_id, _ in rows[drop_every::drop_every]]
    outputs = {uniref: write_outputs(directory, "uniref", sto, hits, name,
                                     len(seq)),
               seqs: sifts_outputs}
    return {
        "jackhmmer": fake_search(os.path.join(directory, "jackhmmer"),
                                 outputs),
        "hhfilter": fake_hhfilter(os.path.join(directory, "hhfilter"),
                                  dropped),
        "uniref90": uniref, "sequence_file": sequence_file,
        "sifts_mapping_table": table, "sifts_sequence_db": seqs,
        "dropped": dropped}
